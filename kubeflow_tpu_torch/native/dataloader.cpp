// Native data-loader kernels for the host-side input pipeline.
//
// The port's copy of kubeflow_tpu/native/dataloader.cpp, unchanged but for
// this comment.  The reference's data path runs in native code too
// (PyTorch's C++ DataLoader workers / TF's tf.data C++ runtime); the
// operator tier never sees it (SURVEY.md §2.5 DP row: "each rank loads its
// own shard").  These are the three host-side hot spots that sit between an
// mmap'd token corpus and the training step's host-to-device copy — kept in
// C++ because they are pure memory-bandwidth loops that the GIL would
// otherwise serialize against the training step's dispatch thread:
//
//   kft_shuffle_indices   deterministic Fisher-Yates epoch shuffle
//                         (splitmix64 PRNG, seed -> identical order on
//                         every host, which is what keeps per-process
//                         shards disjoint without communication)
//   kft_pack_sequences    GPT-style document packing: concatenate docs in
//                         shuffle order, EOS-separated, sliced into fixed
//                         (seq_len+1)-token rows; multi-threaded over rows
//   kft_gather_batch      batch assembly: gather rows by index into a
//                         contiguous buffer (the memcpy loop feeding
//                         the host-to-device copy)
//
// Built with plain g++ -O3 -shared (no deps); loaded via ctypes.  Every
// entry point has a NumPy fallback in train/native_data.py and a parity
// test, so the .so is an accelerator, never a requirement.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// splitmix64: tiny, high-quality, and trivially reproducible in NumPy for
// the fallback/parity tests.
static inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

void kft_shuffle_indices(uint64_t n, uint64_t seed, uint64_t* out) {
  for (uint64_t i = 0; i < n; ++i) out[i] = i;
  uint64_t state = seed;
  // Fisher-Yates; bounded rejection sampling keeps the swap index unbiased
  for (uint64_t i = n; i > 1; --i) {
    uint64_t bound = i;
    uint64_t limit = UINT64_MAX - (UINT64_MAX % bound);
    uint64_t r;
    do {
      r = splitmix64(state);
    } while (r >= limit);
    uint64_t j = r % bound;
    uint64_t tmp = out[i - 1];
    out[i - 1] = out[j];
    out[j] = tmp;
  }
}

// Pack documents (concatenated in `order`, EOS between docs) into rows
// [row0, row0 + n_seqs) of the epoch stream, each (seq_len + 1) tokens,
// writing to out[n_seqs][seq_len+1].  Semantics match the NumPy fallback
// exactly: build the virtual stream doc[order[0]] EOS doc[order[1]] EOS ...
// and cut consecutive rows; the stream is padded with EOS if it runs
// short.  row0 lets a host pack just its own window of the epoch without
// materializing the rest.  Returns the epoch's total row count.
uint64_t kft_pack_sequences(const int32_t* tokens,
                            const uint64_t* doc_offsets,  // n_docs + 1
                            uint64_t n_docs,
                            const uint64_t* order,
                            int32_t eos,
                            uint64_t seq_len,
                            uint64_t row0,
                            uint64_t n_seqs,
                            int32_t* out) {
  const uint64_t row = seq_len + 1;

  // prefix lengths of the shuffled stream so each thread can binary-search
  // its own starting document — no cross-thread state.
  std::vector<uint64_t> stream_prefix(n_docs + 1, 0);
  for (uint64_t d = 0; d < n_docs; ++d) {
    uint64_t len = doc_offsets[order[d] + 1] - doc_offsets[order[d]];
    stream_prefix[d + 1] = stream_prefix[d] + len + 1;  // +1 for EOS
  }
  const uint64_t stream_len = stream_prefix[n_docs];

  unsigned hw = std::thread::hardware_concurrency();
  uint64_t n_threads = hw ? (hw < 8 ? hw : 8) : 1;
  if (n_seqs < n_threads) n_threads = n_seqs ? n_seqs : 1;

  auto worker = [&](uint64_t row_begin, uint64_t row_end) {
    uint64_t pos = (row0 + row_begin) * row;  // stream position of the range
    // find the document containing `pos`
    uint64_t lo = 0, hi = n_docs;
    while (lo < hi) {
      uint64_t mid = (lo + hi) / 2;
      if (stream_prefix[mid + 1] <= pos) lo = mid + 1; else hi = mid;
    }
    uint64_t d = lo;
    uint64_t out_pos = row_begin * row;   // output is window-relative
    const uint64_t out_end = row_end * row;
    while (out_pos < out_end) {
      if (pos >= stream_len || d >= n_docs) {
        out[out_pos++] = eos;  // stream exhausted: EOS padding
        ++pos;
        continue;
      }
      uint64_t in_doc = pos - stream_prefix[d];
      uint64_t doc_len = doc_offsets[order[d] + 1] - doc_offsets[order[d]];
      if (in_doc < doc_len) {
        // contiguous run: copy min(doc remainder, out remainder)
        uint64_t n_copy = doc_len - in_doc;
        uint64_t out_left = out_end - out_pos;
        if (n_copy > out_left) n_copy = out_left;
        std::memcpy(out + out_pos,
                    tokens + doc_offsets[order[d]] + in_doc,
                    n_copy * sizeof(int32_t));
        out_pos += n_copy;
        pos += n_copy;
      } else {
        out[out_pos++] = eos;  // the separator slot after the doc
        ++pos;
        ++d;
      }
    }
  };

  if (n_threads <= 1) {
    worker(0, n_seqs);
  } else {
    std::vector<std::thread> threads;
    uint64_t chunk = (n_seqs + n_threads - 1) / n_threads;
    for (uint64_t t = 0; t < n_threads; ++t) {
      uint64_t b = t * chunk;
      uint64_t e = b + chunk < n_seqs ? b + chunk : n_seqs;
      if (b >= e) break;
      threads.emplace_back(worker, b, e);
    }
    for (auto& th : threads) th.join();
  }
  return (stream_len + row - 1) / row;  // epoch row count
}

void kft_gather_batch(const int32_t* data,
                      uint64_t row_len,
                      const uint64_t* idx,
                      uint64_t n,
                      int32_t* out) {
  for (uint64_t i = 0; i < n; ++i) {
    std::memcpy(out + i * row_len, data + idx[i] * row_len,
                row_len * sizeof(int32_t));
  }
}

}  // extern "C"
