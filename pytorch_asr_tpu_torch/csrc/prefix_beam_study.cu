// Two more designs of the CTC prefix beam search without an LM, for Hopper
// (sm_90a), CUDA C++: the whole search with each beam's tokens carried in
// the block (K13), and the search as one launch a frame with its state in
// device memory (K12).
//
// Replaces:
//   K13 pytorch_asr_tpu/ops/beam_pallas.py:313 prefix_beam_fused
//       (_beam_kernel :128): one program for the whole search, each beam's
//       token buffer (K, L) rebuilt every frame from its parent's, the best
//       beam's tokens returned directly;
//   K12 pytorch_asr_tpu/ops/beam_pallas.py:905 prefix_beam_lanes_stepwise
//       (_beam_kernel_lanes_onestep :842): one frame of the search a launch,
//       the (B, K) state read from and written to device memory, the frame's
//       (parent, append) written to (B, T, K); T launches, then a backtrace
//       (_backtrace :739).
// Python side: ops/beam_cuda.py (prefix_beam_fused, prefix_beam_lanes_stepwise).
// Plain version: decoding/prefix_beam.py::beam_scan_plain with no LM (K13,
// and K12 over the whole search), ::prefix_beam_stepwise_plain (K12's
// pointers every frame and its last state).  Both are bit-equal to them:
// tokens, lengths and scores, and K12's pointers and state, dead beams
// included.
//
// The function is K7's (csrc/prefix_beam.cu) with no LM.  Per frame t < len:
//   stays       stay_pb = lse(pb, pnb) + lp[blank];
//               stay_pnb = last >= 0 ? pnb + lp[last] : NEG_INF;
//   extensions  lane (k, c - 1) appends c = 1 .. V-1:
//               (c == last ? pb : lse(pb, pnb)) + lp[c], NEG_INF at length >= L;
//   absorb      an extension of beam k whose hash equals an alive stay k'
//               adds its pnb into that stay by log-sum-exp and drops out;
//   top-K       the K best of the stays then the lanes in flat order, stays
//               first on ties, then the lower index;
//   dead        a pick with score <= NEG_INF / 2 gets pb = pnb = NEG_INF and
//               hash -(r + 1).
// The lanes are the plain search's (V - 1 a beam, no dead blank lane, unlike
// K7's V), so every field of every pick, dead picks included, is the plain
// search's.  The arithmetic is K7's and K10's, copied: torch.logaddexp's
// formula with the finite NEG_INF, uint32_t hashes (int32 wraparound), the
// 64-bit selection key (the score's order-preserving bits above the
// inverted index).  The frame is K7's too, copied with its comments: a copy,
// and not a header shared with prefix_beam.cu, since a function shared with
// the search kernel there moved ptxas's allocation of K9 and made it several
// times slower (see that file).
//
// Bound on this card: bytes, as K7: logp read once (B T V 4 bytes); K12
// also reads and writes its (B, K) state of 5 fields every frame and writes
// (B, T, K) backpointers.  In practice both are bound by the serial chain of
// frames on B of the 132 SMs, each frame a few block barriers and the
// latency of its phases; K12 adds the launch between frames, the floor of
// any design that launches once a frame (the beam-sharded search does,
// around its exchange).
//
// The frame (search_frame), a thread per candidate (K stays and K (V-1)
// lanes: 512 threads at K 16 over 31 chars), looping past 1024.  Its
// phases, each ended by a block barrier:
//   1. stays (a thread a beam) and extensions (a thread a lane);
//   2. absorb, a thread a (stay, beam) test, the at most one match a stay
//      has found by shuffles (K <= 32 and K kp <= threads; else a thread a
//      stay); meanwhile K13's next row comes in by cp.async into the row's
//      buffer, which no later phase of the frame reads;
//   3. selection keys and sort: warp w computes the keys of its own
//      contiguous segment of the N = K + K (V-1) candidates (at most 32
//      where the warps suffice: 31 at K 16 over 31 chars) and sorts them
//      descending (a bitonic network in its flip form: in registers by
//      shuffles for 32 keys, else in place);
//   4. the merge tree (K <= 32): at each level list i takes list i + h, a
//      warp's lanes the lane-wise max of one list and the other reversed,
//      sorted by five half-cleaners, a barrier a level (4 levels at K 16);
//      warp 0's lane r then holds pick r.  Past K 32 each of the first K
//      keys of a segment counts the keys above it in every segment (binary
//      searches) and a key of rank r < K is pick r.
// Since keys are unique the picks are the K largest in descending order,
// the same as K rounds of a block argmax.
//
// K13 (beam_fused_kernel): one block an utterance with the time loop in the
// block; the beam fields double-buffered and the token buffers (2, K, L)
// int32 in the working set (32 KB at K 16, L 256).  After a frame's picks
// each new beam copies its parent's first plen tokens (plen the parent's
// length, at most L), in 16-byte vectors where L is a multiple of 4, and
// writes its appended char at plen (dropped at L): no entry past a beam's
// length is ever written or read, and the final write fills the best row
// with zeros past its length.  The copy needs no barrier of its own: the
// next frame's first barrier ends it.
//
// K12 (beam_step_kernel): one launch a frame, each block its row: it reads
// the row's state into the working set, runs the frame, and writes the
// picks back over it (in place: each block owns its row); rows past their
// length write the identity pointers and leave the state.  The launcher
// queues the T launches on one stream with Hopper's programmatic dependent
// launch (cudaLaunchKernelEx with programmatic stream serialization): a
// frame's blocks may start while the last frame's still run, carve their
// working set and start their row's cp.async (the row is the caller's
// input), then wait for the last frame's grid to complete
// (griddepcontrol.wait, what cudaGridDependencySynchronize() issues) before
// they read or write the state and the pointers; right after the wait they
// let the next frame's launch begin (griddepcontrol.launch_dependents).
//
// Past a block's shared memory.  Where the working set does not fit (K13's
// token buffers grow with K L: K 32 at L 1024 passes the 232,448 bytes a
// Hopper block may have; K12's frame arrays with K V: K 32 at V 1024), or K
// passes 1024, the same kernel runs in its kInScratch form: the working
// set, laid out as in shared memory, lies in the block's slice of a device
// scratch (L1/L2-resident), the rows come in by plain loads (K12's after
// the wait: a block's slice is its own in every frame), and the beams loop
// over the threads.  Same code, same order of operations, so the same
// result as the shared form.  Counted as prefix_beam_fused_wide and
// prefix_beam_stepwise_wide.  ops/beam_cuda.py mirrors the byte counts
// (fused_bytes, step_bytes).
//
// trace (null in normal use): block 0's thread 0 writes its clocks of each
// frame: K13 (T, 8): the global clock, then the clock at the frame's start
// and after its row (in by then), extensions, absorb, selection, picks and
// its share of the token copy; K12 (T, 9): the global clock, then the clock
// at the kernel's start and after the wait, the state and row, extensions,
// absorb, selection and picks, then the global clock at its end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr uint32_t HASH_MULT = 1000003u;

__device__ __forceinline__ float lse(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// Higher key = better candidate: the score's order-preserving bits, then the
// inverted flat index, so equal scores rank the lower index first.  Never 0.
__device__ __forceinline__ unsigned long long make_key(float s, int idx) {
  if (s == 0.0f) s = 0.0f;  // -0 ranks as +0, as float comparison has it
  uint32_t u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xFFFFFFFFu - (uint32_t)idx);
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  const uint32_t u = (uint32_t)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (uint32_t)key);
}

__device__ __forceinline__ unsigned long long umax(unsigned long long a,
                                                   unsigned long long b) {
  return a > b ? a : b;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Waits until at most N of the thread's newest cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A row of V log-probs into the working set: by cp.async (one group) where
// it is shared memory, waited for by the caller, else by plain loads.
template <bool kAsync>
__device__ __forceinline__ void fetch_row(float* lp, const float* src, int V, int tid, int nt) {
  if constexpr (kAsync) {
    for (int v = tid; v < V; v += nt)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(lp + v)),
                   "l"(src + v)
                   : "memory");
    asm volatile("cp.async.commit_group;" ::: "memory");
  } else {
    for (int v = tid; v < V; v += nt) lp[v] = src[v];
  }
}

// The warp sort of the frame's selection.  Warp w's segment of the N keys
// is [w seg, min(N, (w + 1) seg)), seg = ceil(N / warps).
__device__ __forceinline__ int seg_len(int w, int seg, int N) {
  const int lo = w * seg, hi = min(N, lo + seg);
  return hi > lo ? hi - lo : 0;
}

__device__ __forceinline__ void order_desc(unsigned long long* key, int i, int j) {
  const unsigned long long a = key[i], b = key[j];
  if (b > a) {
    key[i] = b;
    key[j] = a;
  }
}

// Sorts key[0, n) descending, by the 32 lanes of one warp (all must call
// it): the bitonic network over the next power of two P >= n in its flip
// form, where every exchange (i, j), i < j, puts the larger key at i.  Keys
// past n count as 0, below every key, so an exchange whose j is past n
// leaves both in place and is skipped.
__device__ __forceinline__ void warp_sort_desc(unsigned long long* key, int n, int lane) {
  int lg = 0;
  while ((1 << lg) < n) ++lg;
  const int pairs = (1 << lg) >> 1;
  for (int s = 1; s <= lg; ++s) {
    // Flip: in each block of 2^s, i = base + o against base + 2^s - 1 - o.
    for (int q = lane; q < pairs; q += 32) {
      const int base = (q >> (s - 1)) << s, o = q & ((1 << (s - 1)) - 1);
      const int j = base + (1 << s) - 1 - o;
      if (j < n) order_desc(key, base + o, j);
    }
    __syncwarp();
    // Half-cleaners: i against i + 2^e, e = s - 2 down to 0.
    for (int e = s - 2; e >= 0; --e) {
      for (int q = lane; q < pairs; q += 32) {
        const int i = ((q >> e) << (e + 1)) | (q & ((1 << e) - 1));
        if (i + (1 << e) < n) order_desc(key, i, i + (1 << e));
      }
      __syncwarp();
    }
  }
}

// The same network on a segment of at most 32 keys, in registers: lane i
// holds key i (0 past n) and each exchange is a shuffle.
__device__ __forceinline__ unsigned long long warp_sort_desc_reg(unsigned long long v, int n,
                                                                 int lane) {
  for (int s = 1; (1 << (s - 1)) < n; ++s) {
    unsigned long long o = __shfl_xor_sync(0xffffffffu, v, (1 << s) - 1);  // the flip
    v = (lane & ((1 << s) - 1)) < (1 << (s - 1)) ? umax(v, o) : (v < o ? v : o);
    for (int e = s - 2; e >= 0; --e) {
      o = __shfl_xor_sync(0xffffffffu, v, 1 << e);
      v = (lane & (1 << e)) == 0 ? umax(v, o) : (v < o ? v : o);
    }
  }
  return v;
}

// The selection's merge tree over nw sorted segments `seg` keys apart (K
// <= 32 and K <= seg; each holds at least K keys, 0s past its end):
// at each level list i takes list i + h (h = ceil(m / 2) of m lists), warp
// i reading its list's K keys and the other's reversed, their lane-wise
// max a bitonic 32 that holds the top 32 of both, sorted by five
// half-cleaners; a block barrier a level.  All threads call it; lane r of
// warp 0 gets the r-th largest key.
__device__ __forceinline__ unsigned long long merge_tree(unsigned long long* key, int nw,
                                                         int seg, int K, int warp, int lane) {
  unsigned long long v = lane < K ? key[lane] : 0ull;  // a single list
  for (int m = nw; m > 1;) {
    const int h = (m + 1) >> 1;
    if (warp < m - h) {
      const unsigned long long a = lane < K ? key[warp * seg + lane] : 0ull;
      const unsigned long long b = 31 - lane < K ? key[(warp + h) * seg + 31 - lane] : 0ull;
      v = umax(a, b);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
        v = (lane & o) == 0 ? umax(v, u) : (v < u ? v : u);
      }
      if (lane < K) key[warp * seg + lane] = v;
    }
    m = h;
    __syncthreads();
  }
  return v;
}

// How many of the descending keys s[0, n) are above x, n <= P (a power of
// two): a binary search of log2(P) + 1 fixed steps.
__device__ __forceinline__ int count_above(const unsigned long long* s, int n, int P,
                                           unsigned long long x) {
  int i = 0;
  for (int step = P; step > 0; step >>= 1) {
    if (i + step <= n && s[i + step - 1] > x) i += step;
  }
  return i;
}

// Bytes of one block's working set (shared memory, or its slice of the
// scratch; ops/beam_cuda.py mirrors these).  The frame's: keys 8 (N + 32)
// (the 32 zeros the merge tree reads past a short last segment), 4 (2 K +
// K (V-1) + V) of stay and lane candidates and the row, K (V-1) absorbed
// flags.  K13 adds 2 sets of the 5 beam fields and 3 K pick ints (52 K),
// then from the next 16 bytes the token buffers (2, K, L) int32; K12 one set
// of the fields (20 K); each to 16 bytes.
__host__ __device__ inline size_t frame_bytes(int K, int V) {
  return 8 * ((size_t)K + (size_t)K * (V - 1) + 32) +
         4 * (2 * (size_t)K + (size_t)K * (V - 1) + V) + (size_t)K * (V - 1);
}

__host__ __device__ inline size_t fused_bytes(int K, int V, int L) {
  return ((frame_bytes(K, V) + 52 * (size_t)K + 15) / 16 * 16 + 8 * (size_t)K * L + 15) / 16 * 16;
}

__host__ __device__ inline size_t step_bytes(int K, int V) {
  return (frame_bytes(K, V) + 20 * (size_t)K + 15) / 16 * 16;
}

// One utterance's working set, carved from a 16-byte aligned base as the
// functions above count it.  Beam fields come in S sets of K: K13's two
// (double-buffered, set `cur` the current beams), K12's one.
struct StudyWs {
  unsigned long long* key;   // (N + 32) selection keys
  float *spb, *spnb;         // (K) stay candidates
  float* epnb;               // (K (V-1)) extension lanes
  float* lp;                 // (V) the frame's log-probs
  float *pb, *pnb;           // (S K) beam fields
  uint32_t* hsh;             // (S K)
  int *last, *len;           // (S K)
  int *par, *app, *plen;     // (K) K13: each pick's parent, its char (-1 for none), plen
  unsigned char* absorbed;   // (K (V-1))
  int* tok;                  // (2, K, L) K13's token buffers
};

__device__ __forceinline__ StudyWs study_ws(char* base, int K, int V, bool fused) {
  const int KC = K * (V - 1), S = fused ? 2 : 1;
  StudyWs w;
  w.key = reinterpret_cast<unsigned long long*>(base);
  w.spb = reinterpret_cast<float*>(w.key + K + KC + 32);
  w.spnb = w.spb + K;
  w.epnb = w.spnb + K;
  w.lp = w.epnb + KC;
  w.pb = w.lp + V;
  w.pnb = w.pb + S * K;
  w.hsh = reinterpret_cast<uint32_t*>(w.pnb + S * K);
  w.last = reinterpret_cast<int*>(w.hsh + S * K);
  w.len = w.last + S * K;
  w.par = fused ? w.len + S * K : nullptr;
  w.app = fused ? w.par + K : nullptr;
  w.plen = fused ? w.app + K : nullptr;
  w.absorbed = reinterpret_cast<unsigned char*>(fused ? w.plen + K : w.len + S * K);
  w.tok = fused ? reinterpret_cast<int*>(base + (frame_bytes(K, V) + 52 * (size_t)K + 15) / 16 * 16)
                : nullptr;
  return w;
}

// Every beam before the first frame: beam 0 the empty prefix, the rest dead.
__device__ __forceinline__ void init_beams(const StudyWs& w, int K, int tid, int nt) {
  for (int r = tid; r < K; r += nt) {
    w.pb[r] = r == 0 ? 0.0f : NEG_INF;
    w.pnb[r] = NEG_INF;
    w.hsh[r] = (uint32_t)(-(r + 1));
    w.last[r] = -1;
    w.len[r] = 0;
  }
}

// A pick's fields: the stay or lane behind key `pick` as new beam r, from
// the beams of set `cur`.
struct Pick {
  int parent, append, len;
  float pb, pnb;
  uint32_t hash;
  int last;
};

__device__ __forceinline__ Pick take_pick(const StudyWs& w, int cur, unsigned long long pick,
                                          int r, int K, int nb) {
  const uint32_t* hsh = w.hsh + cur * K;
  const int *last = w.last + cur * K, *len = w.len + cur * K;
  Pick p;
  const int j = key_index(pick);
  if (j < K) {
    p.parent = j;
    p.append = -1;
    p.pb = w.spb[j];
    p.pnb = w.spnb[j];
    p.hash = hsh[j];
    p.last = last[j];
    p.len = len[j];
  } else {
    const int lane = j - K, k = lane / nb, c = lane - k * nb + 1;
    p.parent = k;
    p.append = c;
    p.pb = NEG_INF;
    p.pnb = w.epnb[lane];
    p.hash = hsh[k] * HASH_MULT + (uint32_t)c;
    p.last = c;
    p.len = len[k] + 1;
  }
  if (key_score(pick) <= NEG_INF / 2) {  // a dead filler carries no mass
    p.pb = NEG_INF;
    p.pnb = NEG_INF;
    p.hash = (uint32_t)(-(r + 1));
  }
  return p;
}

// One frame of the search by all threads of the block, from the beams of
// set `cur` with the frame's row in w.lp: candidates, absorb, keys, sort,
// and take(r, key) called once for each pick r by the thread that holds it
// (warp 0's lane r where the merge tree runs, else the thread that ranked
// it).  next_row (K13): the next frame's row, fetched into w.lp during the
// absorb and waited for before the return, or null.  ph (block 0's thread
// 0 with a trace, else null): the clocks after the extensions, the absorb
// and the selection.  No barrier after the picks: the caller's.
template <bool kInScratch, typename Take>
__device__ __forceinline__ void search_frame(const StudyWs& w, int cur, int K, int V, int L,
                                             const float* next_row, long long* ph, int tid,
                                             int nt, Take&& take) {
  const int nb = V - 1, KC = K * nb, N = K + KC;
  const float *pb = w.pb + cur * K, *pnb = w.pnb + cur * K;
  const uint32_t* hsh = w.hsh + cur * K;
  const int *last = w.last + cur * K, *len = w.len + cur * K;

  // Stays (a thread a beam) and extensions (a thread a lane).
  for (int r = tid; r < K; r += nt) {
    const float total = lse(pb[r], pnb[r]);
    w.spb[r] = total + w.lp[0];
    w.spnb[r] = last[r] >= 0 ? pnb[r] + w.lp[last[r]] : NEG_INF;
  }
  for (int lane = tid; lane < KC; lane += nt) {
    const int k = lane / nb, c = lane - k * nb + 1;
    const float total = lse(pb[k], pnb[k]);
    float e = (c == last[k] ? pb[k] : total) + w.lp[c];
    if (len[k] >= L) e = NEG_INF;  // the beam is full
    w.epnb[lane] = e;
    w.absorbed[lane] = 0;
  }
  __syncthreads();
  if (ph) ph[0] = clock64();
  if (next_row != nullptr) fetch_row<!kInScratch>(w.lp, next_row, V, tid, nt);

  // Absorb: the char that would turn beam k into alive stay k' is
  // c = h_k' - M h_k (mod 2^32); lane (k, c - 1) when 1 <= c <= V - 1.
  // Where a stay's K tests fit a warp's aligned kp lanes and all K stays'
  // fit the block, a thread a test, the max and the sum by shuffles (the
  // prefixes are distinct, so a stay matches one lane at most and the sum
  // has one term: m + logf(1) is m, as the thread-a-stay loop gives it);
  // else a thread a stay.
  int kp = 1;
  while (kp < K) kp <<= 1;
  if (kp <= 32 && K * kp <= nt) {
    if ((tid >> 5) * 32 < K * kp) {  // warp-uniform: every lane shuffles
      const int r = min(tid / kp, K - 1), k = tid - (tid / kp) * kp;
      const bool mine = tid < K * kp && k < K;
      const float sn = w.spnb[r];
      float e = NEG_INF;
      bool hit = false;
      if (mine && lse(w.spb[r], sn) > NEG_INF / 2) {
        const uint32_t c = hsh[r] - HASH_MULT * hsh[k];
        if (c >= 1u && c <= (uint32_t)nb) {
          w.absorbed[k * nb + c - 1] = 1;
          e = w.epnb[k * nb + c - 1];
          hit = true;
        }
      }
      float m = e;
      for (int o = kp >> 1; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = hit && m > NEG_INF / 2 ? expf(e - m) : 0.0f;
      for (int o = kp >> 1; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (mine && k == 0) w.spnb[r] = lse(sn, m > NEG_INF / 2 ? m + logf(sum) : NEG_INF);
    }
  } else {
    for (int r = tid; r < K; r += nt) {
      const float sn = w.spnb[r];
      float add = NEG_INF;
      if (lse(w.spb[r], sn) > NEG_INF / 2) {
        const uint32_t h2 = hsh[r];
        float m = NEG_INF;
        for (int k = 0; k < K; ++k) {
          const uint32_t c = h2 - HASH_MULT * hsh[k];
          if (c >= 1u && c <= (uint32_t)nb) {
            w.absorbed[k * nb + c - 1] = 1;
            m = fmaxf(m, w.epnb[k * nb + c - 1]);
          }
        }
        if (m > NEG_INF / 2) {
          float sum = 0.0f;
          for (int k = 0; k < K; ++k) {
            const uint32_t c = h2 - HASH_MULT * hsh[k];
            if (c >= 1u && c <= (uint32_t)nb) sum += expf(w.epnb[k * nb + c - 1] - m);
          }
          add = m + logf(sum);
        }
      }
      w.spnb[r] = lse(sn, add);
    }
  }
  __syncthreads();
  if (ph) ph[1] = clock64();

  // Selection keys: stays are candidates 0..K-1, lane l is K + l.
  auto key_of = [&](int j) {
    float s;
    if (j < K) {
      s = lse(w.spb[j], w.spnb[j]);
    } else {
      const int lane = j - K;
      s = w.absorbed[lane] ? NEG_INF : w.epnb[lane];
    }
    return make_key(s, j);
  };
  // Segments of 32 keys where the warps suffice (the rest idle in the
  // sort), else one a warp.  With K <= 32 and segments of at least K keys
  // the sorted segments' tops merge in a tree; else each key is ranked.
  const int nw = min(nt >> 5, (N + 31) >> 5), warp = tid >> 5, lane = tid & 31;
  const int seg = (N + nw - 1) / nw;
  const bool tree = K <= 32 && seg >= K;
  {
    const int s0 = warp * seg, sn = seg_len(warp, seg, N);
    // The tree reads K keys of every segment: a short last one gets 0s
    // (below every key) up to K, past N into the 32 zeros' room.
    const int keep = tree && warp < nw ? max(sn, K) : sn;
    if (seg <= 32) {  // a key a lane, sorted in registers (0 past sn)
      const unsigned long long v = warp_sort_desc_reg(lane < sn ? key_of(s0 + lane) : 0ull,
                                                      sn, lane);
      if (lane < keep) w.key[s0 + lane] = v;
    } else {
      for (int j = s0 + lane; j < s0 + sn; j += 32) w.key[j] = key_of(j);
      __syncwarp();
      warp_sort_desc(w.key + s0, sn, lane);
      if (lane < keep - sn) w.key[s0 + sn + lane] = 0ull;
    }
  }
  __syncthreads();
  if (tree) {
    const unsigned long long v = merge_tree(w.key, nw, seg, K, warp, lane);
    if (ph) ph[2] = clock64();
    if (warp == 0 && lane < K) take(lane, v);
  } else {
    // Rank: only the first K keys of a segment can be picks, and none
    // below theta, the largest K-th key of a segment that has K (K keys
    // are at least it).  A key's rank is the count of keys above it in
    // every segment, its own included (there: its position).
    const int top = min(K, seg);
    int P = 1;
    while (P < top) P <<= 1;
    unsigned long long theta = 0;
    for (int o = 0; o < nw; ++o) {
      if (seg_len(o, seg, N) >= K) theta = umax(theta, w.key[o * seg + K - 1]);
    }
    for (int e = tid; e < nw * top; e += nt) {
      const int sw = e / top, p = e - sw * top;
      if (p >= seg_len(sw, seg, N)) continue;
      const unsigned long long x = w.key[sw * seg + p];
      if (x < theta) continue;
      int rank = 0;
      for (int o = 0; o < nw; ++o)
        rank += count_above(w.key + o * seg, min(top, seg_len(o, seg, N)), P, x);
      if (rank < K) take(rank, x);
    }
    if (ph) ph[2] = clock64();
  }
  if constexpr (!kInScratch) {
    if (next_row != nullptr) cp_async_wait<0>();
  }
}

// K13's copy after a frame's picks: new beam r's tokens are its parent's
// first plen (at most L), then its appended char at plen where plen < L;
// from token buffer `cur` into cur ^ 1.  16-byte vectors where every row
// starts 16-byte aligned (L a multiple of 4), else an int a thread.
__device__ __forceinline__ void copy_tokens(const StudyWs& w, int cur, int K, int L, int tid,
                                           int nt) {
  const int* src = w.tok + (size_t)cur * K * L;
  int* dst = w.tok + (size_t)(cur ^ 1) * K * L;
  if ((L & 3) == 0) {
    const int L4 = L >> 2;
    for (int i = tid; i < K * L4; i += nt) {
      const int r = i / L4, q = i - r * L4, plen = w.plen[r], a = w.app[r];
      if (4 * q >= min(plen + (a >= 0), L)) continue;
      int4 v = reinterpret_cast<const int4*>(src + (size_t)w.par[r] * L)[q];
      if (a >= 0) {
        const int at = plen - 4 * q;
        v.x = at == 0 ? a : v.x;
        v.y = at == 1 ? a : v.y;
        v.z = at == 2 ? a : v.z;
        v.w = at == 3 ? a : v.w;
      }
      reinterpret_cast<int4*>(dst + (size_t)r * L)[q] = v;
    }
  } else {
    for (int i = tid; i < K * L; i += nt) {
      const int r = i / L, at = i - r * L, plen = w.plen[r], a = w.app[r];
      if (at < plen) {
        dst[i] = src[(size_t)w.par[r] * L + at];
      } else if (at == plen && a >= 0) {
        dst[i] = a;
      }
    }
  }
}

// K13: the whole search in one block an utterance, the tokens carried.  The
// bounds name one block an SM: with the thread bound alone ptxas gave the
// shared form 32 registers and spilled; so it has 56 and no spill, and a
// frame is 5% shorter on the H100.
template <bool kInScratch>
__global__ void __launch_bounds__(1024, 1)
    beam_fused_kernel(const float* __restrict__ logp, const int* __restrict__ lens,
                      int* __restrict__ tokens, int* __restrict__ out_len,
                      float* __restrict__ out_score, int T, int V, int K, int L, char* scratch,
                      long long* trace) {
  extern __shared__ __align__(16) unsigned long long smem[];
  char* base = kInScratch ? scratch + (size_t)blockIdx.x * fused_bytes(K, V, L)
                          : reinterpret_cast<char*>(smem);
  const StudyWs w = study_ws(base, K, V, true);
  const int nb = V - 1, b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int n_t = min(max(lens[b], 0), T);
  const float* rows = logp + (size_t)b * T * V;
  init_beams(w, K, tid, nt);
  if (n_t > 0) fetch_row<false>(w.lp, rows, V, tid, nt);  // later rows come in ahead
  __syncthreads();
  int cur = 0;
  for (int t = 0; t < n_t; ++t) {
    long long* tr = trace != nullptr && b == 0 && tid == 0 ? trace + 8 * (size_t)t : nullptr;
    if (tr) {
      tr[0] = (long long)global_ns();
      tr[1] = clock64();
      tr[2] = tr[1];  // the row came in during the last frame's absorb
    }
    const int nx = cur ^ 1;
    search_frame<kInScratch>(
        w, cur, K, V, L, t + 1 < n_t ? rows + (size_t)(t + 1) * V : nullptr,
        tr ? tr + 3 : nullptr, tid, nt, [&](int r, unsigned long long pick) {
          const Pick p = take_pick(w, cur, pick, r, K, nb);
          w.pb[nx * K + r] = p.pb;
          w.pnb[nx * K + r] = p.pnb;
          w.hsh[nx * K + r] = p.hash;
          w.last[nx * K + r] = p.last;
          w.len[nx * K + r] = p.len;
          w.par[r] = p.parent;
          w.app[r] = p.append;
          w.plen[r] = w.len[cur * K + p.parent];
        });
    __syncthreads();
    if (tr) tr[6] = clock64();
    copy_tokens(w, cur, K, L, tid, nt);  // the next frame's first barrier ends it
    if (tr) tr[7] = clock64();
    cur = nx;
  }
  __syncthreads();
  // The best beam: the first of the highest lse(pb, pnb); its tokens, zeros
  // past its length.
  const int o = cur * K;
  int best = 0;
  float bs = lse(w.pb[o], w.pnb[o]);
  for (int k = 1; k < K; ++k) {
    const float s = lse(w.pb[o + k], w.pnb[o + k]);
    if (s > bs) {
      bs = s;
      best = k;
    }
  }
  const int n = min(w.len[o + best], L);
  const int* row = w.tok + ((size_t)cur * K + best) * L;
  for (int i = tid; i < L; i += nt) tokens[(size_t)b * L + i] = i < n ? row[i] : 0;
  if (tid == 0) {
    out_score[b] = bs;
    out_len[b] = w.len[o + best];
  }
}

// K12: one frame, state (B, K) in device memory updated in place;
// parents/appends (B, T, K) get this frame's pointers.  Launched with
// programmatic stream serialization after the last frame (or the init).
template <bool kInScratch>
__global__ void __launch_bounds__(1024) beam_step_kernel(
    const float* __restrict__ logp, const int* __restrict__ lens, int t, float* pb_g,
    float* pnb_g, int* hash_g, int* last_g, int* len_g, int* __restrict__ parents,
    int* __restrict__ appends, int T, int V, int K, int L, char* scratch, long long* trace) {
  const int nb = V - 1, b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const size_t row = (size_t)b * T + t;
  const bool live = t < lens[b];
  long long* tr =
      trace != nullptr && b == 0 && tid == 0 && live ? trace + 9 * (size_t)t : nullptr;
  if (tr) {
    tr[0] = (long long)global_ns();
    tr[1] = clock64();
  }
  extern __shared__ __align__(16) unsigned long long smem[];
  char* base = kInScratch ? scratch + (size_t)blockIdx.x * step_bytes(K, V)
                          : reinterpret_cast<char*>(smem);
  const StudyWs w = study_ws(base, K, V, false);
  // The row is the caller's input, not the last frame's output: in shared
  // memory (this block's own) its copies start before the wait.
  if (live && !kInScratch) fetch_row<true>(w.lp, logp + row * V, V, tid, nt);
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the last frame's state is complete
  asm volatile("griddepcontrol.launch_dependents;");  // the next frame may start its prologue
  if (tr) tr[2] = clock64();
  if (!live) {  // past the row's length: the state stays, the pointers are identity
    for (int r = tid; r < K; r += nt) {
      parents[row * K + r] = r;
      appends[row * K + r] = -1;
    }
    return;
  }
  if (kInScratch) fetch_row<false>(w.lp, logp + row * V, V, tid, nt);
  const size_t so = (size_t)b * K;
  for (int k = tid; k < K; k += nt) {
    w.pb[k] = pb_g[so + k];
    w.pnb[k] = pnb_g[so + k];
    w.hsh[k] = (uint32_t)hash_g[so + k];
    w.last[k] = last_g[so + k];
    w.len[k] = len_g[so + k];
  }
  if constexpr (!kInScratch) cp_async_wait<0>();
  __syncthreads();
  if (tr) tr[3] = clock64();
  search_frame<kInScratch>(w, 0, K, V, L, nullptr, tr ? tr + 4 : nullptr, tid, nt,
                           [&](int r, unsigned long long pick) {
                             const Pick p = take_pick(w, 0, pick, r, K, nb);
                             pb_g[so + r] = p.pb;
                             pnb_g[so + r] = p.pnb;
                             hash_g[so + r] = (int)p.hash;
                             last_g[so + r] = p.last;
                             len_g[so + r] = p.len;
                             parents[row * K + r] = p.parent;
                             appends[row * K + r] = p.append;
                           });
  if (tr) {
    tr[7] = clock64();
    tr[8] = (long long)global_ns();
  }
}

// K12's state before the first frame: beam 0 the empty prefix (pb 0), the
// rest dead, hashes -(k + 1), no last char, length 0.
__global__ void stepwise_init_kernel(float* pb, float* pnb, int* hash, int* last, int* len,
                                     int n, int K) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = i % K;
  pb[i] = k == 0 ? 0.0f : NEG_INF;
  pnb[i] = NEG_INF;
  hash[i] = -(k + 1);
  last[i] = -1;
  len[i] = 0;
}

// K12's end: each row's best beam (the first of the highest lse(pb, pnb)),
// and its tokens from walking the pointers back from the row's last frame,
// left-packed with zeros after (at most L), as K7's backtrace.
__global__ void stepwise_finish_kernel(const float* __restrict__ pb,
                                       const float* __restrict__ pnb,
                                       const int* __restrict__ len,
                                       const int* __restrict__ lens,
                                       const int* __restrict__ parents,
                                       const int* __restrict__ appends, int* __restrict__ tokens,
                                       int* __restrict__ out_len,
                                       float* __restrict__ out_score, int T, int K, int L) {
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < L; i += blockDim.x) tokens[(size_t)b * L + i] = 0;
  __syncthreads();
  if (threadIdx.x != 0) return;
  const size_t so = (size_t)b * K;
  int best = 0;
  float bs = lse(pb[so], pnb[so]);
  for (int k = 1; k < K; ++k) {
    const float s = lse(pb[so + k], pnb[so + k]);
    if (s > bs) {
      bs = s;
      best = k;
    }
  }
  out_score[b] = bs;
  out_len[b] = len[so + best];
  const int n_t = min(max(lens[b], 0), T);
  int count = 0;
  for (int t = n_t - 1, k = best; t >= 0; --t) {
    const size_t at = ((size_t)b * T + t) * K + k;
    count += appends[at] >= 0;
    k = parents[at];
  }
  for (int t = n_t - 1, k = best, pos = count - 1; t >= 0; --t) {
    const size_t at = ((size_t)b * T + t) * K + k;
    if (appends[at] >= 0) {
      if (pos < L) tokens[(size_t)b * L + pos] = appends[at];
      --pos;
    }
    k = parents[at];
  }
}

// A block's threads: a thread a candidate (K stays and K (V-1) lanes), and
// at least K kp (kp = K to a power of two, K <= 32) for the absorb's tests,
// to 32, at most 1024 (past that the phases loop).
int study_threads(int K, int V) {
  long long n = (long long)K + (long long)K * (V - 1);
  int kp = 1;
  while (kp < K) kp <<= 1;
  if (kp <= 32 && (long long)K * kp > n) n = (long long)K * kp;
  return n >= 1024 ? 1024 : (int)(n + 31) / 32 * 32;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// K12's T frame launches, each after the last with programmatic stream
// serialization.
template <bool kInScratch>
cudaError_t launch_frames(const float* logp, const int* lens, float* pb, float* pnb, int* hash,
                          int* last, int* len, int* parents, int* appends, int B, int T, int V,
                          int K, int L, char* scratch, long long* trace, cudaStream_t st) {
  auto kernel = beam_step_kernel<kInScratch>;
  const size_t smem = kInScratch ? 0 : step_bytes(K, V);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B);
  cfg.blockDim = dim3(study_threads(K, V));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (int t = 0; t < T; ++t) {
    err = cudaLaunchKernelEx(&cfg, kernel, logp, lens, t, pb, pnb, hash, last, len, parents,
                             appends, T, V, K, L, scratch, trace);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// K13: logp (B, T, V) fp32 log-softmaxed, lens (B) int32 -> the best beam's
// tokens (B, L) int32 (zeros past its length), its length (B) and score (B).
// scratch: null keeps each block's working set in shared memory (the
// wrapper checks its size and K <= 1024), else a device scratch of B
// fused_bytes(K, V, L) bytes, 16-byte aligned, holds it.  trace: null, or
// (T, 8) int64 for block 0's clocks of each frame.
extern "C" int prefix_beam_fused(const float* logp, const int* lens, int* tokens, int* out_len,
                                 float* out_score, int B, int T, int V, int K, int L,
                                 void* scratch, long long* trace, void* stream) {
  if (B == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const int threads = study_threads(K, V);
  char* slices = static_cast<char*>(scratch);
  if (slices != nullptr) {
    beam_fused_kernel<true><<<B, threads, 0, st>>>(logp, lens, tokens, out_len, out_score, T, V,
                                                   K, L, slices, trace);
    return cudaGetLastError();
  }
  const size_t smem = fused_bytes(K, V, L);
  const cudaError_t err = allow_smem(beam_fused_kernel<false>, smem);
  if (err != cudaSuccess) return err;
  beam_fused_kernel<false><<<B, threads, smem, st>>>(logp, lens, tokens, out_len, out_score, T,
                                                     V, K, L, nullptr, trace);
  return cudaGetLastError();
}

// K12: the whole search as T launches of one frame each, on one stream:
// the state (B, K) pb, pnb, hash, last, len and the pointers (B, T, K) are
// the caller's scratch; outputs as prefix_beam_fused.  scratch: null, or a
// device scratch of B step_bytes(K, V) bytes for the working sets.  trace:
// null, or (T, 9) int64 for block 0's clocks of each frame.
extern "C" int prefix_beam_stepwise(const float* logp, const int* lens, float* pb, float* pnb,
                                    int* hash, int* last, int* len, int* parents, int* appends,
                                    int* tokens, int* out_len, float* out_score, int B, int T,
                                    int V, int K, int L, void* scratch, long long* trace,
                                    void* stream) {
  if (B == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  stepwise_init_kernel<<<(B * K + 255) / 256, 256, 0, st>>>(pb, pnb, hash, last, len, B * K, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  char* slices = static_cast<char*>(scratch);
  err = slices != nullptr
            ? launch_frames<true>(logp, lens, pb, pnb, hash, last, len, parents, appends, B, T, V,
                                  K, L, slices, trace, st)
            : launch_frames<false>(logp, lens, pb, pnb, hash, last, len, parents, appends, B, T,
                                   V, K, L, nullptr, trace, st);
  if (err != cudaSuccess) return err;
  stepwise_finish_kernel<<<B, 32, 0, st>>>(pb, pnb, len, lens, parents, appends, tokens,
                                           out_len, out_score, T, K, L);
  return cudaGetLastError();
}
