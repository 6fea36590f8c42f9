/**
 * JSON-RPC client for the KmerGuts annotation service.
 *
 * Counterpart of the reference's generated jQuery client
 * (lib/javascript/Client.js, which exposes only status because the KIDL
 * module is empty). This client uses fetch(), no dependencies, and also
 * drives the real `annotate` method.
 *
 * Usage:
 *   const c = new KmerGutsClient("http://host:5000");
 *   const st = await c.status();
 *   const report = await c.annotate({fasta: ">P1\nACDEF...", aa: true});
 */
class KmerGutsClient {
  constructor(url, timeoutMs = 600000, token = null) {
    this.url = url;
    this.timeoutMs = timeoutMs;
    this.token = token;
    this._id = 0;
  }

  async _call(method, params) {
    const controller = new AbortController();
    const timer = setTimeout(() => controller.abort(), this.timeoutMs);
    const headers = { "Content-Type": "application/json" };
    if (this.token) headers["Authorization"] = this.token;
    try {
      const resp = await fetch(this.url, {
        method: "POST",
        headers,
        body: JSON.stringify({
          version: "1.1",
          method: `KmerGutsJava.${method}`,
          params: params,
          id: String(++this._id),
        }),
        signal: controller.signal,
      });
      const body = await resp.json();
      if (body.error) {
        const e = body.error;
        throw new Error(`${e.name || "JSONRPCError"} (${e.code}): ${e.message}`);
      }
      return body.result;
    } finally {
      clearTimeout(timer);
    }
  }

  async status() {
    return (await this._call("status", []))[0];
  }

  /** options: {fasta | fasta_path, aa, min_hits, min_weighted_hits,
   *  max_gap, order_constraint, debug, backend} -> report text */
  async annotate(options) {
    return (await this._call("annotate", [options]))[0].report;
  }

  /** Async-job protocol (reference Client.js polls with 100 ms -> x1.5
   *  backoff capped at 5 min, :13-16). */
  async annotateSubmit(options) {
    return (await this._call("_annotate_submit", [options]))[0];
  }

  async checkJob(jobId) {
    return (await this._call("_check_job", [jobId]))[0];
  }

  async annotateAsync(options) {
    const jobId = await this.annotateSubmit(options);
    let delay = 100;
    for (;;) {
      const job = await this.checkJob(jobId);
      if (job.finished) {
        if (job.error) {
          const e = job.error;
          throw new Error(`${e.name || "JSONRPCError"} (${e.code}): ${e.message}`);
        }
        return job.result[0].report;
      }
      await new Promise((r) => setTimeout(r, delay));
      delay = Math.min(delay * 1.5, 300000);
    }
  }
}

if (typeof module !== "undefined") {
  module.exports = { KmerGutsClient };
}
