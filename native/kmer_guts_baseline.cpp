// Single-core baseline: the reference engine's streaming merge-join lookup
// (algorithm of KmerGutsJava.java
// :944-1034, reimplemented in C++ — this image has no JVM, so this is the
// measured stand-in for the Java baseline; C++ is strictly faster than the
// JVM original, which makes the device-vs-baseline ratio conservative).
//
// Usage: kmer_guts_baseline <kmer.table.mem_map> <queries.bin> [reps]
//   queries.bin: records of {int64 value, int32 cntId, int32 pos}, sorted by
//   (value % numSigs, value) — the reference's spill-file order (ref :656-660,
//   :1082-1094).
// Prints one JSON line with lookup timing.

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

static const long long MAX_ENCODED = 25600000000LL; // 20^8

#pragma pack(push, 1)
struct Slot {
  long long kmer;
  int32_t otu;
  int32_t avg_from_end;
  int32_t fi;
  float wt;
};
struct Query {
  long long value;
  int32_t cnt;
  int32_t pos;
};
#pragma pack(pop)

struct Hit {
  int32_t cnt;
  int32_t pos;
  int32_t otu;
  int32_t avg;
  int32_t fi;
  float wt;
};

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s <table> <queries.bin> [reps]\n", argv[0]);
    return 2;
  }
  int reps = argc > 3 ? atoi(argv[3]) : 1;

  FILE* tf = fopen(argv[1], "rb");
  if (!tf) { perror("table"); return 1; }
  long long header[3];
  if (fread(header, sizeof(long long), 3, tf) != 3) { fprintf(stderr, "bad header\n"); return 1; }
  long long num_sigs = header[0];
  if (header[1] != (long long)sizeof(Slot)) { fprintf(stderr, "bad entry size\n"); return 1; }

  FILE* qf = fopen(argv[2], "rb");
  if (!qf) { perror("queries"); return 1; }
  fseek(qf, 0, SEEK_END);
  size_t nq = ftell(qf) / sizeof(Query);
  fseek(qf, 0, SEEK_SET);
  std::vector<Query> queries(nq);
  if (fread(queries.data(), sizeof(Query), nq, qf) != nq) { fprintf(stderr, "bad queries\n"); return 1; }
  fclose(qf);

  double best = 1e30;
  size_t total_hits = 0;
  long long kmers_found = 0;
  for (int rep = 0; rep < reps; rep++) {
    fseek(tf, sizeof(long long) * 3, SEEK_SET);
    std::vector<Hit> hits;
    hits.reserve(nq / 2);
    std::unordered_map<long long, std::vector<const Query*>> in_progress;
    in_progress.reserve(64);
    kmers_found = 0;

    auto t0 = std::chrono::steady_clock::now();
    long long cur = 0;  // next slot the stream will read
    size_t qi = 0;
    Slot slot;
    // forward-only merge-join over the table stream (ref :964-1026)
    while (qi < nq || !in_progress.empty()) {
      long long needed = cur;
      if (in_progress.empty()) {
        const Query& q = queries[qi];
        needed = q.value % num_sigs;
        in_progress[q.value].push_back(&q);
        qi++;
      }
      while (qi < nq && queries[qi].value % num_sigs == needed) {
        in_progress[queries[qi].value].push_back(&queries[qi]);
        qi++;
      }
      if (needed > cur) {
        fseek(tf, (needed - cur) * (long long)sizeof(Slot), SEEK_CUR);
        cur = needed;
      }
      if (fread(&slot, sizeof(Slot), 1, tf) != 1) {
        fprintf(stderr, "table truncated at slot %lld\n", cur);
        break;
      }
      if (slot.kmer > MAX_ENCODED) {
        in_progress.clear();
      } else {
        auto it = in_progress.find(slot.kmer);
        if (it != in_progress.end()) {
          kmers_found++;
          for (const Query* q : it->second) {
            hits.push_back({q->cnt, q->pos, slot.otu, slot.avg_from_end,
                            slot.fi, slot.wt});
          }
          in_progress.erase(it);
        }
      }
      cur++;
    }
    auto t1 = std::chrono::steady_clock::now();
    double secs = std::chrono::duration<double>(t1 - t0).count();
    if (secs < best) best = secs;
    total_hits = hits.size();
  }
  fclose(tf);

  printf("{\"queries\": %zu, \"hits\": %zu, \"kmers_found\": %lld, "
         "\"lookup_seconds\": %.6f, \"lookups_per_sec\": %.1f}\n",
         nq, total_hits, kmers_found, best, nq / best);
  return 0;
}
