// Document-pack index builder (the port's copy of
// scaling_tpu/native/pack_index.cpp).
//
// The same spans as build_pack_index_plain in __init__.py: greedy packing
// of whole documents into windows of sequence_length + 1 tokens, over-long
// documents split, and every allow_incomplete_every_n-th window allowed to
// cut a document. O(num_docs); the Python loop takes minutes over the
// index of a billion-token corpus. A plain C interface over raw pointers,
// loaded with ctypes; the caller owns all memory.
//
// Build: g++ -O3 -shared -fPIC -o libpack_index.so pack_index.cpp

#include <cstdint>

extern "C" {

// Returns the number of spans; writes up to max_spans (start, end) pairs.
// A span of L+1 tokens overlapping its neighbour by 1 marks a mid-document
// cut; other spans end at document boundaries.
int64_t build_pack_index(
    const int64_t* doc_sizes,
    int64_t num_docs,
    int64_t sequence_length,
    int64_t allow_incomplete_every_n,
    int64_t* out_starts,
    int64_t* out_ends,
    int64_t max_spans) {
  const int64_t L = sequence_length;
  int64_t total = 0;
  for (int64_t d = 0; d < num_docs; ++d) total += doc_sizes[d];

  int64_t n_spans = 0;
  auto emit = [&](int64_t s, int64_t e) {
    if (e - s >= 2 && s + 2 <= total && n_spans < max_spans) {
      out_starts[n_spans] = s;
      out_ends[n_spans] = e;
      ++n_spans;
    }
  };

  int64_t window_start = 0;
  int64_t since_cut = 0;
  int64_t doc_start = 0;
  const int64_t every_n = allow_incomplete_every_n;

  for (int64_t d = 0; d < num_docs; ++d) {
    const int64_t doc_end = doc_start + doc_sizes[d];
    if (doc_end - window_start <= L) {
      doc_start = doc_end;
      continue;  // the document fits into the open window
    }
    if (every_n > 0 && since_cut + 1 >= every_n) {
      // the every-n exception: cut mid-document with a 1-token overlap
      while (doc_end - window_start > L) {
        emit(window_start, window_start + L + 1);
        window_start += L;
      }
      since_cut = 0;
      doc_start = doc_end;
      continue;
    }
    // close the open window at this document's start
    if (doc_start > window_start) {
      emit(window_start, doc_start);
      ++since_cut;
    }
    window_start = doc_start;
    if (doc_end - window_start > L) {
      // an over-long document: full L+1 windows, the tail dropped
      while (doc_end - window_start > L) {
        emit(window_start, window_start + L + 1);
        window_start += L;
        since_cut = 0;
      }
      window_start = doc_end;
    }
    doc_start = doc_end;
  }
  if (total - window_start >= 2) emit(window_start, total);
  return n_spans;
}

}  // extern "C"
