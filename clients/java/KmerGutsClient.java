// JSON-RPC client for the KmerGuts annotation service.
//
// Counterpart of the reference's generated Java client
// (the reference's lib/src/kmergutsjava/KmerGutsJavaClient.java, which
// exposes only status() because the KIDL module is empty). This client is
// dependency-free (JDK 11+ java.net.http plus a built-in minimal JSON
// codec) and also drives the real `annotate` method and the async-job
// submit/poll protocol (same wire shape as the reference's baseclient
// _submit_job/_check_job; poll backoff 100 ms -> x1.5 capped at 5 min,
// matching the reference's JS client, lib/javascript/Client.js:13-16).
//
// Usage:
//   KmerGutsClient c = new KmerGutsClient("http://host:5000");
//   Map<String, Object> st = c.status();
//   Map<String, Object> params = new HashMap<>();
//   params.put("fasta", ">P1\nACDEFGHIKLMNPQRS\n");
//   params.put("aa", true);
//   String report = c.annotate(params);
//
// Compile: javac KmerGutsClient.java   (no external jars)

package kmerguts;

import java.io.IOException;
import java.net.URI;
import java.net.http.HttpClient;
import java.net.http.HttpRequest;
import java.net.http.HttpResponse;
import java.time.Duration;
import java.util.ArrayList;
import java.util.Collections;
import java.util.LinkedHashMap;
import java.util.List;
import java.util.Map;

public class KmerGutsClient {

    /** Server-reported JSON-RPC error. */
    public static class ServerException extends RuntimeException {
        public final String name;
        public final long code;

        public ServerException(String name, long code, String message) {
            super(name + " (" + code + "): " + message);
            this.name = name;
            this.code = code;
        }
    }

    private final String url;
    private final String token;
    private final HttpClient http;
    private long nextId = 0;

    public KmerGutsClient(String url) {
        this(url, null, Duration.ofSeconds(600));
    }

    public KmerGutsClient(String url, String token) {
        this(url, token, Duration.ofSeconds(600));
    }

    public KmerGutsClient(String url, String token, Duration timeout) {
        this.url = url;
        this.token = token;
        this.http = HttpClient.newBuilder().connectTimeout(timeout).build();
    }

    // ------------------------------------------------------------------
    // RPC surface (kmergutsjava_tpu/service/SPEC.md)
    // ------------------------------------------------------------------

    /** status() -> {state, message, version, git_url, git_commit_hash}. */
    @SuppressWarnings("unchecked")
    public Map<String, Object> status() throws IOException, InterruptedException {
        List<Object> r = call("status", Collections.emptyList());
        return (Map<String, Object>) r.get(0);
    }

    /** warm() -> {num_sigs, max_probe, probe_window}. */
    @SuppressWarnings("unchecked")
    public Map<String, Object> warm() throws IOException, InterruptedException {
        List<Object> r = call("warm", Collections.emptyList());
        return (Map<String, Object>) r.get(0);
    }

    /** Synchronous annotate; returns the engine's text report. */
    @SuppressWarnings("unchecked")
    public String annotate(Map<String, Object> params)
            throws IOException, InterruptedException {
        List<Object> r = call("annotate", Collections.singletonList(params));
        return (String) ((Map<String, Object>) r.get(0)).get("report");
    }

    /** Submit an async annotate job; returns the job id. */
    public String annotateSubmit(Map<String, Object> params)
            throws IOException, InterruptedException {
        List<Object> r = call("_annotate_submit",
                Collections.singletonList(params));
        return (String) r.get(0);
    }

    /** Poll one job: {job_id, finished, result?/error?}. */
    @SuppressWarnings("unchecked")
    public Map<String, Object> checkJob(String jobId)
            throws IOException, InterruptedException {
        List<Object> r = call("_check_job", Collections.singletonList(jobId));
        return (Map<String, Object>) r.get(0);
    }

    /** Submit + poll to completion (100 ms -> x1.5 backoff, cap 5 min). */
    @SuppressWarnings("unchecked")
    public String annotateAsync(Map<String, Object> params)
            throws IOException, InterruptedException {
        String jobId = annotateSubmit(params);
        long sleepMs = 100;
        while (true) {
            Map<String, Object> job = checkJob(jobId);
            Object fin = job.get("finished");
            boolean finished = fin instanceof Number
                    ? ((Number) fin).longValue() != 0
                    : Boolean.TRUE.equals(fin);
            if (finished) {
                if (job.containsKey("error")) {
                    Map<String, Object> e = (Map<String, Object>) job.get("error");
                    throw new ServerException(
                            String.valueOf(e.getOrDefault("name", "JSONRPCError")),
                            e.get("code") instanceof Number
                                    ? ((Number) e.get("code")).longValue() : -32000L,
                            String.valueOf(e.getOrDefault("message", "")));
                }
                List<Object> result = (List<Object>) job.get("result");
                return (String) ((Map<String, Object>) result.get(0)).get("report");
            }
            Thread.sleep(sleepMs);
            sleepMs = Math.min(sleepMs * 3 / 2, 300_000);
        }
    }

    // ------------------------------------------------------------------
    // Transport
    // ------------------------------------------------------------------

    @SuppressWarnings("unchecked")
    private List<Object> call(String method, List<Object> params)
            throws IOException, InterruptedException {
        Map<String, Object> payload = new LinkedHashMap<>();
        payload.put("version", "1.1");
        payload.put("method", "KmerGutsJava." + method);
        payload.put("params", params);
        payload.put("id", String.valueOf(++nextId));
        HttpRequest.Builder b = HttpRequest.newBuilder()
                .uri(URI.create(url))
                .header("Content-Type", "application/json")
                .POST(HttpRequest.BodyPublishers.ofString(Json.write(payload)));
        if (token != null) {
            b.header("Authorization", token);
        }
        HttpResponse<String> res =
                http.send(b.build(), HttpResponse.BodyHandlers.ofString());
        Object body = Json.parse(res.body());
        if (!(body instanceof Map)) {
            throw new IOException("malformed server response (HTTP "
                    + res.statusCode() + ")");
        }
        Map<String, Object> m = (Map<String, Object>) body;
        if (m.get("error") != null) {
            Map<String, Object> e = (Map<String, Object>) m.get("error");
            throw new ServerException(
                    String.valueOf(e.getOrDefault("name", "JSONRPCError")),
                    e.get("code") instanceof Number
                            ? ((Number) e.get("code")).longValue() : -32000L,
                    String.valueOf(e.getOrDefault("message", "")));
        }
        return (List<Object>) m.get("result");
    }

    // ------------------------------------------------------------------
    // Minimal JSON codec (objects -> LinkedHashMap, arrays -> ArrayList,
    // numbers -> Long when integral else Double)
    // ------------------------------------------------------------------

    static final class Json {

        static String write(Object o) {
            StringBuilder sb = new StringBuilder();
            writeValue(o, sb);
            return sb.toString();
        }

        @SuppressWarnings("unchecked")
        private static void writeValue(Object o, StringBuilder sb) {
            if (o == null) {
                sb.append("null");
            } else if (o instanceof String) {
                writeString((String) o, sb);
            } else if (o instanceof Boolean || o instanceof Long
                    || o instanceof Integer) {
                sb.append(o);
            } else if (o instanceof Number) {
                sb.append(((Number) o).doubleValue());
            } else if (o instanceof Map) {
                sb.append('{');
                boolean first = true;
                for (Map.Entry<String, Object> e
                        : ((Map<String, Object>) o).entrySet()) {
                    if (!first) {
                        sb.append(',');
                    }
                    first = false;
                    writeString(e.getKey(), sb);
                    sb.append(':');
                    writeValue(e.getValue(), sb);
                }
                sb.append('}');
            } else if (o instanceof List) {
                sb.append('[');
                boolean first = true;
                for (Object e : (List<Object>) o) {
                    if (!first) {
                        sb.append(',');
                    }
                    first = false;
                    writeValue(e, sb);
                }
                sb.append(']');
            } else {
                throw new IllegalArgumentException(
                        "unsupported JSON type: " + o.getClass());
            }
        }

        private static void writeString(String s, StringBuilder sb) {
            sb.append('"');
            for (int i = 0; i < s.length(); i++) {
                char c = s.charAt(i);
                switch (c) {
                    case '"': sb.append("\\\""); break;
                    case '\\': sb.append("\\\\"); break;
                    case '\n': sb.append("\\n"); break;
                    case '\r': sb.append("\\r"); break;
                    case '\t': sb.append("\\t"); break;
                    case '\b': sb.append("\\b"); break;
                    case '\f': sb.append("\\f"); break;
                    default:
                        if (c < 0x20) {
                            sb.append(String.format("\\u%04x", (int) c));
                        } else {
                            sb.append(c);
                        }
                }
            }
            sb.append('"');
        }

        static Object parse(String s) {
            Parser p = new Parser(s);
            Object v = p.value();
            p.skipWs();
            if (p.pos != s.length()) {
                throw new IllegalArgumentException(
                        "trailing JSON content at " + p.pos);
            }
            return v;
        }

        private static final class Parser {
            final String s;
            int pos = 0;

            Parser(String s) {
                this.s = s;
            }

            void skipWs() {
                while (pos < s.length()
                        && Character.isWhitespace(s.charAt(pos))) {
                    pos++;
                }
            }

            char peek() {
                if (pos >= s.length()) {
                    throw new IllegalArgumentException("unexpected end of JSON");
                }
                return s.charAt(pos);
            }

            void expect(char c) {
                if (peek() != c) {
                    throw new IllegalArgumentException(
                            "expected '" + c + "' at " + pos);
                }
                pos++;
            }

            Object value() {
                skipWs();
                char c = peek();
                switch (c) {
                    case '{': return object();
                    case '[': return array();
                    case '"': return string();
                    case 't': literal("true"); return Boolean.TRUE;
                    case 'f': literal("false"); return Boolean.FALSE;
                    case 'n': literal("null"); return null;
                    default: return number();
                }
            }

            void literal(String lit) {
                if (!s.startsWith(lit, pos)) {
                    throw new IllegalArgumentException(
                            "bad literal at " + pos);
                }
                pos += lit.length();
            }

            Map<String, Object> object() {
                expect('{');
                Map<String, Object> m = new LinkedHashMap<>();
                skipWs();
                if (peek() == '}') {
                    pos++;
                    return m;
                }
                while (true) {
                    skipWs();
                    String k = string();
                    skipWs();
                    expect(':');
                    m.put(k, value());
                    skipWs();
                    char c = peek();
                    pos++;
                    if (c == '}') {
                        return m;
                    }
                    if (c != ',') {
                        throw new IllegalArgumentException(
                                "expected ',' or '}' at " + (pos - 1));
                    }
                }
            }

            List<Object> array() {
                expect('[');
                List<Object> l = new ArrayList<>();
                skipWs();
                if (peek() == ']') {
                    pos++;
                    return l;
                }
                while (true) {
                    l.add(value());
                    skipWs();
                    char c = peek();
                    pos++;
                    if (c == ']') {
                        return l;
                    }
                    if (c != ',') {
                        throw new IllegalArgumentException(
                                "expected ',' or ']' at " + (pos - 1));
                    }
                }
            }

            String string() {
                expect('"');
                StringBuilder sb = new StringBuilder();
                while (true) {
                    char c = peek();
                    pos++;
                    if (c == '"') {
                        return sb.toString();
                    }
                    if (c == '\\') {
                        char e = peek();
                        pos++;
                        switch (e) {
                            case '"': sb.append('"'); break;
                            case '\\': sb.append('\\'); break;
                            case '/': sb.append('/'); break;
                            case 'n': sb.append('\n'); break;
                            case 'r': sb.append('\r'); break;
                            case 't': sb.append('\t'); break;
                            case 'b': sb.append('\b'); break;
                            case 'f': sb.append('\f'); break;
                            case 'u':
                                sb.append((char) Integer.parseInt(
                                        s.substring(pos, pos + 4), 16));
                                pos += 4;
                                break;
                            default:
                                throw new IllegalArgumentException(
                                        "bad escape at " + (pos - 1));
                        }
                    } else {
                        sb.append(c);
                    }
                }
            }

            Object number() {
                int start = pos;
                while (pos < s.length()
                        && "+-0123456789.eE".indexOf(s.charAt(pos)) >= 0) {
                    pos++;
                }
                String t = s.substring(start, pos);
                if (t.isEmpty()) {
                    throw new IllegalArgumentException(
                            "bad number at " + start);
                }
                if (t.indexOf('.') < 0 && t.indexOf('e') < 0
                        && t.indexOf('E') < 0) {
                    try {
                        return Long.parseLong(t);
                    } catch (NumberFormatException ignored) {
                        // fall through to double
                    }
                }
                return Double.parseDouble(t);
            }
        }

        private Json() {
        }
    }

    // ------------------------------------------------------------------
    // Smoke CLI: java kmerguts.KmerGutsClient http://host:5000 [token]
    // ------------------------------------------------------------------

    public static void main(String[] args) throws Exception {
        if (args.length < 1) {
            System.err.println(
                    "usage: java kmerguts.KmerGutsClient URL [token]");
            System.exit(2);
        }
        KmerGutsClient c = new KmerGutsClient(
                args[0], args.length > 1 ? args[1] : null);
        System.out.println(Json.write(c.status()));
    }
}
