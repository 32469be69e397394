// The leaf-tile traversal core shared by the heap-walk kernel (K2,
// csrc/traverse.cu) and the streaming kernel (K3, csrc/traverse_stream.cu).
//
// Both kernels see a BVH as two levels: a binary heap of S "super" nodes
// (heap nodes S-1 .. 2S-2, S a power of two) and F leaf clusters under each
// super (super s owns leaves s*F .. s*F + F - 1). K3's BVH is built that way
// (its fanout); K2 takes a flat BVH and cuts it at F = min(C, CHUNK) leaves.
// The TPU kernels (ops/pallas/stream.py::_make_stream_kernel, ops/pallas/
// traverse.py::_make_kernel) run one near-to-far schedule per tile of rays
// and DMA each visited leaf once per tile; so does this core:
//
//   * a block of THREADS threads owns a tile of TILE consecutive rays; the
//     caller sorts the wavefront by the entry-morton key (ops/traverse.py::
//     _entry_morton_perms), so the rays of a tile enter the same leaves;
//   * the first TILE threads walk, one a ray, the heap above the supers,
//     nearer child first, with a stack of log2(S) + 1 entries in shared
//     memory, to the next super the tile has not visited; the tile takes the
//     nearest of those (block argmin of the entries), marks it visited, and
//     every ray whose entry into it is within its best t joins it;
//   * the joined rays test the super's child boxes, CHUNK at a time (fanout
//     up to any power of two is served in rounds), into an entry matrix in
//     shared memory; the chunk's children are visited in the order of their
//     nearest entry, and the round ends at the first child whose nearest
//     entry lies beyond every joined ray's best t;
//   * each visited leaf's contiguous [W, K] block is copied once into shared
//     memory by cp.async, double-buffered: the next leaf loads while this
//     one is tested;
//   * each (ray, leaf) pair whose entry is within the ray's best t tests the
//     leaf's unit boxes (one box a UNIT = 32 rows, ops/bvh.py::unit_boxes);
//     every unit its ray enters within its best t is a work item; each warp
//     takes a run of items, lanes over the unit's rows, reading the block
//     from shared memory, and merges the item's nearest row into its ray's
//     64-bit key (ordered t bits, row) with atomicMin.
//
// Results are independent of the visiting order: a node, super or child is
// pruned only when its entry exceeds the ray's best t (an equal entry is
// kept), and the key's minimum is the lexicographic minimum (t, row) over all
// rows with t in (t_min, min(t_max, INF)) (INF, the leaf tests' miss, is no
// hit even below t_max = inf): the brute-force twin's row on every ray,
// exact t ties across clusters included. An any hit ends its ray at the
// first acceptance (its key's t becomes -1 inside, 0 in the output).
//
// Mixed mode (K3's third instance, for the joint closest+shadow pass of
// ops/traverse.py::joint_closest_any): each ray's any-hit flag comes from
// is_any [R] and is kept beside the tile's ray record as one bit a ray, so
// closest-hit and shadow rays share one tile and one schedule. A shadow
// ray that accepts is done exactly as in the any-hit instance: its best t
// is -1 and every box entry is clamped to >= 0 (leaf_tests.cuh::slab), so
// no walk, join, pair or unit test takes it again; a dead ray (t_max = 0,
// the dead half of a pair) is never joined.
//
// Leaf element type T (K3's bf16 pack, ops/cuda/stream.py::pack_prim_hbm):
// a bf16 leaf is W*K*2 bytes, copied 16 or 4 bytes a cp.async where its
// size allows and by plain loads otherwise (an odd W*K), and read as f32
// (leaf_tests.cuh::ld, exact). Its boxes bound the rounded rows.
//
// Unit-major order (the bf16 and the tensor-core instances): the (pair,
// unit) take flags put each pair's ray on the list of every unit whose box
// it enters, in place of the (pair, unit) item list. The tensor-core
// instances take a unit entered by n rays as ceil(n / UNIT_RAYS) tiles of up
// to UNIT_RAYS = 8 of those rays, each warp every WARPS-th tile of the leaf.
// The bf16 instances take the leaf's (unit, ray) items in unit-major order,
// each warp a run of them: a lane holds its row of the unit in registers,
// two bf16 a word, while its run stays in the unit, and tests the rays with
// the f32 test (cone_row, tri_row) from there. The f32 instances read a row
// once a (pair, unit) item.
//
// kMxu (K3's tensor-core cone test, ops/pallas/stream.py::_cone_block_mxu):
// when the leaf has landed, each row's b.u, b.v, b.w is computed once into
// shared memory (the plain version's order, bx*ux + by*uy + bz*uz), beside
// its slope, r_base, min_d and max_d in f32 (the row side). A warp
// takes a tile and the unit's rows MXU_ROWS = 8 at a time: mma.sync m16n8k8
// (TF32 in, f32 accumulated) of A (16 x 8: row i < 8 ray i's o, row 8 + i its
// d) with B (8 x 8: column j row j's u, v or w) gives o.f and d.f of each
// (ray, row) for one frame vector f, so three products give the six
// projections, and each lane tests its two (ray, row) elements with
// leaf_tests.cuh's cone_uw and cone_v (u and w first, then v: fewer
// projections live at once). Precision: the operands are split as x ~ hi +
// lo, hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi) (-fmad=false keeps x -
// hi from contracting), and the ray's halves are folded into the depth: A's
// row is [x_hi (3) | x_lo (3) | 0 0] and B's column [f_hi (3); f_hi (3); 0 0],
// so one pass sums x_hi.f_hi + x_lo.f_hi; an f32 row adds x_hi.f_lo first, in
// a second pass (B = [f_lo (3); 0; 0]). A bf16 row is exact in TF32 (f_lo =
// 0): one pass. The dropped x_lo.f_lo and the halves' own rounding leave a
// projection within 2^-20 sum |x_k f_k| of the exact one (tests/
// test_torch_stream_variants.py), where one TF32 pass keeps 11 bits.

#pragma once

#include <climits>
#include <cuda_runtime.h>

#include "leaf_tests.cuh"

namespace fur {

// The tile shape, chosen by tile_sweep.py (a build may override it with
// -DFUR_TILE_RAYS=... -DFUR_TILE_THREADS=...; TILE a multiple of 32, at
// most THREADS, THREADS at least CHUNK).
#ifndef FUR_TILE_RAYS
#define FUR_TILE_RAYS 128
#endif
#ifndef FUR_TILE_THREADS
#define FUR_TILE_THREADS 512
#endif
constexpr int TILE = FUR_TILE_RAYS;        // rays of a block
constexpr int THREADS = FUR_TILE_THREADS;  // threads of a block, for the box and leaf work
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 1024 / THREADS;  // blocks an SM should hold: at most 64 registers
constexpr int UNIT_RAYS = 8;  // rays of a unit-major tile (m16n8k8's 16 A rows: their o and d)
constexpr int MXU_ROWS = 8;   // leaf rows of an mma tile
constexpr int CHUNK = 64;     // child boxes tested per round
constexpr int UNIT = 32;      // rows of a leaf under one unit box (ops/bvh.py::unit_boxes)
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SHARED = 232448;  // bytes a block may opt in to on Hopper

// Dynamic shared memory, in 4-byte words: the ray keys [TILE] (8 bytes
// each), rays [10][TILE] (o, d, 1/d, t_max), joined rays and pairs [TILE]
// each, the entry matrix [CHUNK][TILE], child boxes [6][CHUNK], child minima
// and visiting order [CHUNK] each; then the walk stacks [depth][TILE] (node,
// entry), the visited-super bits, the list of (pair, unit) work items
// [TILE * U] (U = ceil(K / UNIT)), or for the unit-major instances (bf16
// leaves, mxu) in its place the list of each unit's rays [U][TILE], then
// the units' ray counts [U] (mxu: also their first tiles [U + 1] and the row
// side [7][K]); two leaf buffers of W*K elements of `elem` bytes each at a
// 16-byte boundary.
struct TileLayout {
  int stack, visited, units, counts, rside, leaf, words;
};

__host__ __device__ inline TileLayout tile_layout(int w, int leaf_k, int n_sup, int depth,
                                                  int elem = 4, bool mxu = false) {
  TileLayout l;
  const int units = (leaf_k + UNIT - 1) / UNIT;
  l.stack = (2 + 10 + 2 + CHUNK) * TILE + 8 * CHUNK;
  l.visited = l.stack + 2 * depth * TILE;
  l.units = l.visited + (n_sup + 31) / 32;
  l.counts = l.units + TILE * units;
  l.rside = mxu ? l.counts + 2 * units + 1 : elem == 2 ? l.counts + units : l.counts;
  l.leaf = (l.rside + (mxu ? 7 * leaf_k : 0) + 3) / 4 * 4;
  l.words = l.leaf + (2 * w * leaf_k * elem + 3) / 4;
  return l;
}

// Work counters of a build with -DFUR_TILE_STATS (off otherwise; tile_sweep.py
// reads them), summed over the blocks of the launches since they were
// zeroed, read by the tile_stats entry points below: [0] blocks, [1] super
// visits, [2] rays joined to them, [3] child rounds, [4] children entered,
// [5] leaves tested, [6] (ray, leaf) pairs, [7] leaf copies issued, [8]
// (ray, unit) work items, [9] unit-major tiles (the bf16 and tensor-core
// instances; their rays are [8]).
#ifdef FUR_TILE_STATS
__device__ unsigned long long tile_stats[16];
#define FUR_STAT(i, v) \
  if (threadIdx.x == 0) atomicAdd(&tile_stats[i], static_cast<unsigned long long>(v))
#else
#define FUR_STAT(i, v)
#endif

// Entries of the walk's stack: log2(S) + 1 for a near-to-far walk of a
// complete binary heap over S supers.
inline int walk_depth(int n_sup) {
  int h = 0;
  while ((1 << h) < n_sup) ++h;
  return h + 1;
}

// Float bits in an order-preserving unsigned form and back (the key of a ray
// is ord(t) << 32 | row, so its unsigned minimum is the (t, row) minimum).
__device__ __forceinline__ unsigned ord(float x) {
  unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unord(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ unsigned long long ray_key(float t, unsigned row) {
  return (static_cast<unsigned long long>(ord(t)) << 32) | row;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Lexicographic (value, index) minimum over the warp.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(FULL, v, off);
    int oi = __shfl_xor_sync(FULL, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// Is a box entry (INF on a miss) within a ray's best t? An entry equal to it
// is (its ties must be tested); a miss is not, even when the best t is INF.
__device__ __forceinline__ bool within(float e, float t_best) { return e < INF && e <= t_best; }

// Appends `id` to list[] (counter *n) where `take` holds; one atomic a warp.
// Every lane of the warp calls it.
__device__ __forceinline__ void append(bool take, int id, int* list, int* n) {
  const int lane = threadIdx.x & 31;
  unsigned m = __ballot_sync(FULL, take);
  int base = 0;
  if (lane == 0 && m) base = atomicAdd(n, __popc(m));
  base = __shfl_sync(FULL, base, 0);
  if (take) list[base + __popc(m & ((1u << lane) - 1u))] = id;
}

// Copies one leaf's [W, K] block into shared memory (this thread's share),
// 16 bytes a copy where the block allows it.
__device__ __forceinline__ void load_leaf(float* dst, const float* __restrict__ packed, int leaf,
                                          int wk) {
  const float* src = packed + static_cast<size_t>(leaf) * wk;
  if ((wk & 3) == 0) {
    for (int x = threadIdx.x; x < wk / 4; x += THREADS) cp_async16(dst + 4 * x, src + 4 * x);
  } else {
    for (int x = threadIdx.x; x < wk; x += THREADS) cp_async4(dst + x, src + x);
  }
}

// The same for a bf16 block (2 bytes an element): 16 or 4 bytes a copy where
// the block's size allows it (every block then starts at such a boundary),
// else plain loads. The destination buffer is free when it is called (the
// tile's tests of it ended at a barrier), and the barrier before its tests
// publishes the plain stores as it does the copies.
__device__ __forceinline__ void load_leaf(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ packed, int leaf,
                                          int wk) {
  const __nv_bfloat16* src = packed + static_cast<size_t>(leaf) * wk;
  if ((wk & 7) == 0) {
    for (int x = threadIdx.x; x < wk / 8; x += THREADS) cp_async16(dst + 8 * x, src + 8 * x);
  } else if ((wk & 1) == 0) {
    for (int x = threadIdx.x; x < wk / 2; x += THREADS) cp_async4(dst + 2 * x, src + 2 * x);
  } else {
    for (int x = threadIdx.x; x < wk; x += THREADS) dst[x] = src[x];
  }
}

// x as TF32 rounded to nearest, ties away from zero (its low 13 bits 0).
__device__ __forceinline__ unsigned tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The low half of x's split x ~ hi + lo (hi = tf32_rna(x)), both TF32.
__device__ __forceinline__ unsigned tf32_lo(float x, unsigned hi) {
  return tf32_rna(x - __uint_as_float(hi));
}

// c += a (16 x 8, row) * b (8 x 8, col) on the tensor cores, TF32 in, f32 out.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// This lane's two A elements of one ray's vector x = v[0..2] (v[c * TILE],
// the tile's ray record): the row [x_hi (3) | x_lo (3) | 0 0] at depth tig
// (x_hi[tig], or x_lo[0] for tig 3) and depth tig + 4 (x_lo[tig + 1] for tig
// 0, 1; else 0). Zeros for a ray that tests nothing.
__device__ __forceinline__ void mxu_a(const float* v, bool ok, int tig, unsigned& at,
                                      unsigned& at4) {
  const float xa = ok ? v[(tig < 3 ? tig : 0) * TILE] : 0.0f;
  const float xb = ok && tig < 2 ? v[(tig + 1) * TILE] : 0.0f;
  const unsigned ha = tf32_rna(xa), hb = tf32_rna(xb);
  at = tig < 3 ? ha : tf32_lo(xa, ha);
  at4 = tf32_lo(xb, hb);
}

// One frame vector f's projections of a lane's elements: c = A * B with A =
// the tile's [x_hi | x_lo | 0 0] rows (o above, d below) and B's column j =
// row j's [f_hi; f_hi; 0 0] (this lane: b0 = f_hi at depth tig, bh1 at tig +
// 4), one pass for x_hi.f_hi + x_lo.f_hi; an f32 row (kExactB false) sums
// x_hi.f_lo first, the small term, in a pass of its own (B = [f_lo; 0; 0]:
// bl0 = f_lo at depth tig < 3).
template <bool kExactB>
__device__ __forceinline__ void mxu_proj(float (&c)[4], const unsigned (&a)[4], unsigned bh0,
                                         unsigned bh1, unsigned bl0) {
  c[0] = c[1] = c[2] = c[3] = 0.0f;
  if constexpr (!kExactB) mma_tf32(c, a, bl0, 0u);
  mma_tf32(c, a, bh0, bh1);
}

// Boxes: the source of the box tables, with
//   int n_sup, fanout;
//   float node(int n, int a)      component a (lo xyz, hi xyz) of walk node n
//                                 (heap nodes 0 .. 2S-2);
//   float child(int s, int c, int a)  component a of child c of super s.
//
// kMixed: the any-hit flag of each ray comes from is_any [R] (1 = shadow
// ray, else closest hit); kAnyHit must be false then. kMxu: cone rows by the
// tensor-core loop (cones only). T: the leaf element type (float or bf16).
template <bool kCone, bool kAnyHit, bool kMixed = false, bool kMxu = false, class T,
          class Boxes>
__device__ __forceinline__ void tile_traverse(
    const Boxes& bx, int n_rays, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_max, const T* __restrict__ packed,
    const float* __restrict__ uboxes, int leaf_k, int depth, float t_min,
    float* __restrict__ t_out, int* __restrict__ row_out, unsigned char* __restrict__ found_out,
    const unsigned char* __restrict__ is_any = nullptr) {
  static_assert(!(kAnyHit && kMixed), "a mixed tile takes each ray's flag from is_any");
  static_assert(kCone || !kMxu, "the tensor-core loop tests cone rows");
  constexpr int W = kCone ? 16 : 9;
  constexpr int RAY_WARPS = TILE / 32;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_e[RAY_WARPS];
  __shared__ int red_s[RAY_WARPS];
  __shared__ unsigned any_bits[kMixed ? RAY_WARPS : 1];  // the rays' any-hit flags, a bit each
  __shared__ int s_star, n_join, n_pairs, n_vis, n_items;
  __shared__ unsigned s_max_tb;  // ord() of the largest best t of the joined rays

  const int n_sup = bx.n_sup, fanout = bx.fanout, wk = W * leaf_k;
  const TileLayout lay =
      tile_layout(W, leaf_k, n_sup, depth, static_cast<int>(sizeof(T)), kMxu);
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem);  // [TILE]
  float* ray = smem + 2 * TILE;  // [10][TILE]
  int* join = reinterpret_cast<int*>(ray + 10 * TILE);
  int* pairs = join + TILE;
  float* ent = reinterpret_cast<float*>(pairs + TILE);  // [CHUNK][TILE] by join slot
  float* cbox = ent + CHUNK * TILE;                      // [6][CHUNK]
  float* cmin = cbox + 6 * CHUNK;
  int* order = reinterpret_cast<int*>(cmin + CHUNK);
  int* stk_node = reinterpret_cast<int*>(smem + lay.stack);  // [depth][TILE]
  float* stk_e = smem + lay.stack + depth * TILE;
  unsigned* visited = reinterpret_cast<unsigned*>(smem + lay.visited);
  int* items = reinterpret_cast<int*>(smem + lay.units);  // [TILE * U]
  int* ulist = items;  // unit-major: [U][TILE]
  T* leaf_buf = reinterpret_cast<T*>(smem + lay.leaf);  // [2][W*K]
  const int units = (leaf_k + UNIT - 1) / UNIT;  // unit boxes of a leaf
  int* ucnt = reinterpret_cast<int*>(smem + lay.counts);  // unit-major: rays a unit [U]
  int* ubase = ucnt + units;  // mxu: the first tile of each unit [U + 1]
  float* rside = smem + lay.rside;  // mxu: b.u, b.v, b.w, slope, r_base, min_d, max_d [7][K]
  auto best_t = [&](int q) { return unord(static_cast<unsigned>(key[q] >> 32)); };
  auto any_ray = [&](int q) { return ((any_bits[q >> 5] >> (q & 31)) & 1u) != 0u; };

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool walker = t < TILE;
  const int i = blockIdx.x * TILE + t;
  Ray r = {0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f};
  float cap = 0.0f;
  if (walker && i < n_rays) {
    r.ox = o[3 * i]; r.oy = o[3 * i + 1]; r.oz = o[3 * i + 2];
    r.dx = d[3 * i]; r.dy = d[3 * i + 1]; r.dz = d[3 * i + 2];
    cap = t_max[i];
  }
  const bool live = walker && i < n_rays && cap > 0.0f;
  // A ray with a non-finite origin or a NaN direction hits no row (its
  // tests give NaN), but fminf/fmaxf drop the NaN of an inf * 0 slab term
  // and would let it enter every box on its finite axes (the Whitted shadow
  // rays of a miss start at inf): NaN inverse directions make its every
  // slab test miss, as the twin finds nothing for it.
  const bool inert = !(isfinite(r.ox) && isfinite(r.oy) && isfinite(r.oz)) || isnan(r.dx) ||
                     isnan(r.dy) || isnan(r.dz);
  const float nan = __int_as_float(0x7fffffff);
  const float ix = inert ? nan : safe_inv(r.dx), iy = inert ? nan : safe_inv(r.dy),
              iz = inert ? nan : safe_inv(r.dz);
  if (walker) {
    ray[0 * TILE + t] = r.ox; ray[1 * TILE + t] = r.oy; ray[2 * TILE + t] = r.oz;
    ray[3 * TILE + t] = r.dx; ray[4 * TILE + t] = r.dy; ray[5 * TILE + t] = r.dz;
    ray[6 * TILE + t] = ix; ray[7 * TILE + t] = iy; ray[8 * TILE + t] = iz;
    ray[9 * TILE + t] = cap;
    key[t] = ray_key(cap, 0xffffffffu);
  }
  bool my_any = kAnyHit;  // this walker's ray ends at its first acceptance
  if constexpr (kMixed) {
    my_any = walker && i < n_rays && is_any[i] != 0;
    if (warp < RAY_WARPS) {
      const unsigned m = __ballot_sync(FULL, my_any);
      if (lane == 0) any_bits[warp] = m;
    }
  }
  for (int x = t; x < (n_sup + 31) / 32; x += THREADS) visited[x] = 0u;
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr bool kUnitMajor = kMxu || kBf16;  // unit-major tiles (see above)
  if constexpr (kUnitMajor)
    for (int x = t; x < units; x += THREADS) ucnt[x] = 0;
  if (t == 0) { n_pairs = 0; n_items = 0; s_max_tb = 0u; }

  auto node_entry = [&](int n, float tb) {
    return slab(r, ix, iy, iz, bx.node(n, 0), bx.node(n, 1), bx.node(n, 2), bx.node(n, 3),
                bx.node(n, 4), bx.node(n, 5), tb);
  };
  int sp = 0;
  if (live) {
    float e = node_entry(0, cap);
    if (e < INF) { stk_node[t] = 0; stk_e[t] = e; sp = 1; }
  }
  __syncthreads();
  FUR_STAT(0, 1);

  while (true) {
    // Each ray walks on to the nearest super the tile has not visited.
    const float tb = walker ? best_t(t) : -1.0f;
    float ce = INF;
    int cs = INT_MAX;
    while (sp > 0) {
      const int node = stk_node[(sp - 1) * TILE + t];
      const float e = stk_e[(sp - 1) * TILE + t];
      if (e > tb) { --sp; continue; }  // pruned by a nearer hit found since
      if (node >= n_sup - 1) {
        const int s = node - (n_sup - 1);
        if ((visited[s >> 5] >> (s & 31)) & 1u) { --sp; continue; }
        ce = e;
        cs = s;
        break;
      }
      --sp;
      const int c0 = 2 * node + 1, c1 = c0 + 1;
      const float e0 = node_entry(c0, tb), e1 = node_entry(c1, tb);
      int near = c0, far = c1;
      float en = e0, ef = e1;
      if (e1 < e0) { near = c1; far = c0; en = e1; ef = e0; }
      if (ef < INF) { stk_node[sp * TILE + t] = far; stk_e[sp * TILE + t] = ef; ++sp; }
      if (en < INF) { stk_node[sp * TILE + t] = near; stk_e[sp * TILE + t] = en; ++sp; }
    }
    // The tile visits the nearest of those supers.
    if (warp < RAY_WARPS) {
      warp_argmin(ce, cs);
      if (lane == 0) { red_e[warp] = ce; red_s[warp] = cs; }
    }
    __syncthreads();
    if (t == 0) {
      float me = red_e[0];
      int ms = red_s[0];
      for (int w = 1; w < RAY_WARPS; ++w)
        if (red_e[w] < me || (red_e[w] == me && red_s[w] < ms)) { me = red_e[w]; ms = red_s[w]; }
      s_star = me < INF ? ms : -1;
      if (me < INF) visited[ms >> 5] |= 1u << (ms & 31);
      n_join = 0;
    }
    __syncthreads();
    const int s = s_star;
    if (s < 0) break;
    append(live && within(node_entry(n_sup - 1 + s, tb), tb), t, join, &n_join);
    __syncthreads();
    const int nj = n_join;
    FUR_STAT(1, 1);
    FUR_STAT(2, nj);

    for (int c0 = 0; c0 < fanout; c0 += CHUNK) {
      const int n = min(CHUNK, fanout - c0);
      for (int x = t; x < 6 * n; x += THREADS) {
        const int a = x / n, c = x - a * n;
        cbox[a * CHUNK + c] = bx.child(s, c0 + c, a);
      }
      __syncthreads();
      for (int x = t; x < nj * n; x += THREADS) {
        const int c = x / nj, jj = x - c * nj, q = join[jj];
        const Ray rq = {ray[q], ray[TILE + q], ray[2 * TILE + q],
                        ray[3 * TILE + q], ray[4 * TILE + q], ray[5 * TILE + q]};
        ent[c * TILE + jj] = slab(rq, ray[6 * TILE + q], ray[7 * TILE + q], ray[8 * TILE + q],
                                  cbox[c], cbox[CHUNK + c], cbox[2 * CHUNK + c],
                                  cbox[3 * CHUNK + c], cbox[4 * CHUNK + c], cbox[5 * CHUNK + c],
                                  best_t(q));
      }
      __syncthreads();
      for (int c = warp; c < n; c += WARPS) {  // a warp a child, lanes over rays
        float m = INF;
        for (int jj = lane; jj < nj; jj += 32) m = fminf(m, ent[c * TILE + jj]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(FULL, m, off));
        if (lane == 0) cmin[c] = m;
      }
      __syncthreads();
      if (t < n) {
        int rank = 0;
        for (int c = 0; c < n; ++c)
          rank += cmin[c] < cmin[t] || (cmin[c] == cmin[t] && c < t);
        order[rank] = t;
      }
      if (t == 0) {
        int nv = 0;
        for (int c = 0; c < n; ++c) nv += cmin[c] < INF;
        n_vis = nv;
      }
      __syncthreads();
      const int nv = n_vis;
      FUR_STAT(3, 1);
      FUR_STAT(4, nv);
      FUR_STAT(7, nv > 0);
      if (nv > 0) load_leaf(leaf_buf, packed, s * fanout + c0 + order[0], wk);
      cp_async_commit();
      for (int v = 0; v < nv; ++v) {
        const int cur = v & 1;
        if (v + 1 < nv) {
          load_leaf(leaf_buf + (cur ^ 1) * wk, packed, s * fanout + c0 + order[v + 1], wk);
          FUR_STAT(7, 1);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        // The pairs of this child, and the largest best t of the joined rays.
        const int c = order[v];
        const int q = t < nj ? join[t] : 0;
        const float tq = t < nj ? best_t(q) : -INF;
        append(t < nj && within(ent[c * TILE + t], tq), q, pairs, &n_pairs);
        unsigned mt = ord(tq);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mt = max(mt, __shfl_xor_sync(FULL, mt, off));
        if (lane == 0 && warp < RAY_WARPS) atomicMax(&s_max_tb, mt);
        __syncthreads();
        // Children are in the order of their nearest entry: past this one
        // no joined ray needs any.
        if (!(cmin[c] <= unord(s_max_tb))) break;
        const int np = n_pairs;
        FUR_STAT(5, 1);
        FUR_STAT(6, np);
        const T* blk = leaf_buf + cur * wk;
        const int leaf = s * fanout + c0 + c;
        if constexpr (kMxu) {  // each row's b.u, b.v, b.w (the plain version's
          for (int k = t; k < leaf_k; k += THREADS) {  // order) and its 4 scalars, f32
            const T* pr = blk + k;
            const float bx = ld(pr), by = ld(pr + leaf_k), bz = ld(pr + 2 * leaf_k);
            rside[k] = bx * ld(pr + 3 * leaf_k) + by * ld(pr + 4 * leaf_k) +
                       bz * ld(pr + 5 * leaf_k);
            rside[leaf_k + k] = bx * ld(pr + 6 * leaf_k) + by * ld(pr + 7 * leaf_k) +
                                bz * ld(pr + 8 * leaf_k);
            rside[2 * leaf_k + k] = bx * ld(pr + 9 * leaf_k) + by * ld(pr + 10 * leaf_k) +
                                    bz * ld(pr + 11 * leaf_k);
            for (int e = 12; e < 16; ++e) rside[(e - 9) * leaf_k + k] = ld(pr + e * leaf_k);
          }
        }
        // The work items: the units of UNIT rows whose box each pair's ray
        // enters within its best t.
        const float* ub = uboxes + static_cast<size_t>(leaf) * 6 * units;
        for (int x0 = 0; x0 < np * units; x0 += THREADS) {
          const int x = x0 + t;
          bool take = false;
          if (x < np * units) {
            const int p = x / units, u = x - p * units, qq = pairs[p];
            const Ray rq = {ray[qq], ray[TILE + qq], ray[2 * TILE + qq],
                            ray[3 * TILE + qq], ray[4 * TILE + qq], ray[5 * TILE + qq]};
            const float tbq = best_t(qq);
            take = within(slab(rq, ray[6 * TILE + qq], ray[7 * TILE + qq], ray[8 * TILE + qq],
                               ub[u], ub[units + u], ub[2 * units + u], ub[3 * units + u],
                               ub[4 * units + u], ub[5 * units + u], tbq),
                          tbq);
          }
          if constexpr (kUnitMajor) {  // the pair's ray joins the unit's list
            if (take) {
              const int u = x % units;
              ulist[u * TILE + atomicAdd(&ucnt[u], 1)] = pairs[x / units];
            }
          }
          if constexpr (!kUnitMajor) {
            append(take, x, items, &n_items);
          } else if constexpr (!kMxu) {  // bf16: the leaf's (unit, ray) items
            const unsigned m = __ballot_sync(FULL, take);
            if (lane == 0 && m) atomicAdd(&n_items, __popc(m));
          }
        }
        __syncthreads();
#ifdef FUR_TILE_STATS
        if constexpr (kUnitMajor) {
          if (t == 0) {
            int held = 0, tiles = 0;
            for (int u = 0; u < units; ++u) {
              held += ucnt[u];
              tiles += (ucnt[u] + UNIT_RAYS - 1) / UNIT_RAYS;
            }
            FUR_STAT(8, held);
            FUR_STAT(9, tiles);
          }
        }
#endif
        if constexpr (kMxu) {
          if (t == 0) {  // the units' tiles in order: ceil(rays / UNIT_RAYS) a unit
            int n = 0;
            for (int u = 0; u < units; ++u) {
              ubase[u] = n;
              n += (ucnt[u] + UNIT_RAYS - 1) / UNIT_RAYS;
            }
            ubase[units] = n;
          }
          __syncthreads();
          // Each warp takes every WARPS-th tile and the unit's rows MXU_ROWS
          // at a time: A's row gid is ray gid's o, row gid + 8 its d, and a
          // lane holds (ray gid) x (rows 2 tig, 2 tig + 1 of the 8): c0, c1
          // the o.f, c2, c3 the d.f of the m16n8k8 accumulator fragment.
          const int gid = lane >> 2, tig = lane & 3;
          for (int y = warp, u = 0; y < ubase[units]; y += WARPS) {
            while (ubase[u + 1] <= y) ++u;
            const int slot = (y - ubase[u]) * UNIT_RAYS + gid;
            const int q = slot < ucnt[u] ? ulist[u * TILE + slot] : 0;
            bool qa = kAnyHit;
            if constexpr (kMixed) qa = any_ray(q);
            // a shadow ray done by an earlier tile tests nothing more
            const bool ok = slot < ucnt[u] && !(qa && best_t(q) < 0.0f);
            if (!__any_sync(FULL, ok)) continue;
            unsigned a[4];  // A: this lane's o at rows gid (a0, a2), d at gid + 8 (a1, a3)
            mxu_a(ray + q, ok, tig, a[0], a[2]);
            mxu_a(ray + 3 * TILE + q, ok, tig, a[1], a[3]);
            float best = INF;
            int brow = INT_MAX;
            for (int r0 = u * UNIT; r0 < min(leaf_k, (u + 1) * UNIT); r0 += MXU_ROWS) {
              // B's column gid: row r0 + gid's f at depth 0-2 and again at
              // 3-5 (b0 at depth tig, b1 at tig + 4); f = u and w, then v
              const int n = r0 + gid;
              const auto project = [&](float (&cf)[4], int f) {
                const T* col = blk + (3 + 3 * f) * leaf_k + n;
                const float fa = n < leaf_k ? ld(col + (tig < 3 ? tig : 0) * leaf_k) : 0.0f;
                const float fb = n < leaf_k && tig < 2 ? ld(col + (tig + 1) * leaf_k) : 0.0f;
                if constexpr (kBf16) {  // exact in TF32
                  mxu_proj<true>(cf, a, __float_as_uint(fa), __float_as_uint(fb), 0u);
                } else {
                  const unsigned ha = tf32_rna(fa);
                  mxu_proj<false>(cf, a, ha, tf32_rna(fb), tig < 3 ? tf32_lo(fa, ha) : 0u);
                }
              };
              ConeUW uw[2];
              {
                float pu[4], pw[4];
                project(pu, 0);
                project(pw, 2);
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                  const int rr = min(r0 + 2 * tig + j, leaf_k - 1);
                  uw[j] = cone_uw(pu[j], pw[j], pu[2 + j], pw[2 + j], rside[rr],
                                  rside[2 * leaf_k + rr]);
                }
              }
              float pv[4];
              project(pv, 1);
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int rr = r0 + 2 * tig + j;
                if (rr >= leaf_k) continue;
                const float* rs = rside + rr;
                const float lt = ok ? cone_v(uw[j], pv[j], pv[2 + j], rs[leaf_k], rs[3 * leaf_k],
                                             rs[4 * leaf_k], rs[5 * leaf_k], rs[6 * leaf_k],
                                             t_min, ray[9 * TILE + q])
                                    : INF;
                if (lt < best) {  // rows ascend in a lane: the lowest of equal t
                  best = lt;
                  brow = rr;
                }
              }
            }
            // The quad's lanes hold the same ray: its (t, row) minimum.
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
              const float ot = __shfl_xor_sync(FULL, best, off);
              const int orow = __shfl_xor_sync(FULL, brow, off);
              if (ot < best || (ot == best && orow < brow)) {
                best = ot;
                brow = orow;
              }
            }
            // INF is a miss, also below an infinite t_max (the twin's rule)
            if (tig == 0 && ok && best < ray[9 * TILE + q] && best < INF &&
                !(qa && best_t(q) < 0.0f))
              atomicMin(&key[q], ray_key(qa ? -1.0f : best,
                                         static_cast<unsigned>(leaf * leaf_k + brow)));
          }
        } else if constexpr (kBf16) {
          // The leaf's (unit, ray) items in unit-major order, each warp a run
          // of them, lanes over the unit's rows: this lane's row held in
          // registers (two bf16 a word) from where the run reaches its unit;
          // each warp finds its run's first unit from the counts itself.
          const int total = n_items;
          const int run = (total + WARPS - 1) / WARPS, y_end = min(total, (warp + 1) * run);
          Bf16Row<W> row;
          for (int y = warp * run, u = -1, first = 0; y < y_end; ++y) {
            if (u < 0 || y >= first + ucnt[u]) {  // the run reaches a new unit
              if (u >= 0) first += ucnt[u];
              for (++u; y >= first + ucnt[u]; ++u) first += ucnt[u];
              const int k = u * UNIT + lane;
#pragma unroll
              for (int e = 0; e < (W + 1) / 2; ++e) {
                const unsigned lo =
                    k < leaf_k ? __bfloat16_as_ushort(blk[2 * e * leaf_k + k]) : 0u;
                const unsigned hi = 2 * e + 1 < W && k < leaf_k
                                        ? __bfloat16_as_ushort(blk[(2 * e + 1) * leaf_k + k])
                                        : 0u;
                row.w[e] = lo | hi << 16;
              }
            }
            const int k = u * UNIT + lane;
            const int qq = ulist[u * TILE + y - first];
            bool qany = kAnyHit;
            if constexpr (kMixed) qany = any_ray(qq);
            if (qany && best_t(qq) < 0.0f) continue;  // done by another item
            const Ray rq = {ray[qq], ray[TILE + qq], ray[2 * TILE + qq],
                            ray[3 * TILE + qq], ray[4 * TILE + qq], ray[5 * TILE + qq]};
            const float qcap = ray[9 * TILE + qq];
            float lt = INF;
            if (k < leaf_k) {
              if constexpr (kCone) lt = cone_row(rq, Bf16RowRef<W>{&row, 0}, 1, t_min, qcap);
              else lt = tri_row(rq, Bf16RowRef<W>{&row, 0}, 1, t_min, qcap);
            }
            int lr = lt < INF ? k : INT_MAX;
            warp_argmin(lt, lr);
            // INF is a miss, also below an infinite t_max (the twin's rule)
            if (lane == 0 && lt < qcap && lt < INF)
              atomicMin(&key[qq], ray_key(qany ? -1.0f : lt,
                                          static_cast<unsigned>(leaf * leaf_k + lr)));
          }
        } else {
          // Each warp takes a run of consecutive items (a pair's units lie
          // together), lanes over the rows of a unit.
          const int ni = n_items, run = (ni + WARPS - 1) / WARPS;
          FUR_STAT(8, ni);
          int qq = -1;
          Ray rq = {0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f};
          float qcap = 0.0f;
          bool qany = kAnyHit;
          for (int y = warp * run; y < min(ni, (warp + 1) * run); ++y) {
            const int x = items[y], p = x / units, k = (x - p * units) * UNIT + lane;
            if (pairs[p] != qq) {
              qq = pairs[p];
              rq = {ray[qq], ray[TILE + qq], ray[2 * TILE + qq],
                    ray[3 * TILE + qq], ray[4 * TILE + qq], ray[5 * TILE + qq]};
              qcap = ray[9 * TILE + qq];
              if constexpr (kMixed) qany = any_ray(qq);
            }
            if (qany && best_t(qq) < 0.0f) continue;  // done by another item
            float lt = INF;
            if (k < leaf_k)
              lt = kCone ? cone_row(rq, blk + k, leaf_k, t_min, qcap)
                         : tri_row(rq, blk + k, leaf_k, t_min, qcap);
            int lr = lt < INF ? k : INT_MAX;
            warp_argmin(lt, lr);
            // INF is a miss, also below an infinite t_max (the twin's rule)
            if (lane == 0 && lt < qcap && lt < INF)
              atomicMin(&key[qq], ray_key(qany ? -1.0f : lt,
                                          static_cast<unsigned>(leaf * leaf_k + lr)));
          }
        }
        __syncthreads();
        if (t == 0) { n_pairs = 0; n_items = 0; s_max_tb = 0u; }
        if constexpr (kUnitMajor)
          for (int x = t; x < units; x += THREADS) ucnt[x] = 0;
      }
      cp_async_wait<0>();
      __syncthreads();
      if (t == 0) { n_pairs = 0; n_items = 0; s_max_tb = 0u; }
    }
  }
  if constexpr (kUnitMajor && kMixed)  // read again: not kept live across the walk
    my_any = walker && i < n_rays && is_any[i] != 0;
  if (walker && i < n_rays) {
    const unsigned long long kq = key[t];
    const unsigned low = static_cast<unsigned>(kq);
    const bool found = low != 0xffffffffu;
    t_out[i] = my_any && found ? 0.0f : unord(static_cast<unsigned>(kq >> 32));
    row_out[i] = found ? static_cast<int>(low) : -1;
    found_out[i] = found ? 1 : 0;
  }
}

}  // namespace fur

#ifdef FUR_TILE_STATS
// The work counters (a -DFUR_TILE_STATS build only), read and zeroed
// through ctypes.
extern "C" int tile_stats_read(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, fur::tile_stats, sizeof(fur::tile_stats)));
}

extern "C" int tile_stats_zero() {
  unsigned long long zero[16] = {};
  return static_cast<int>(cudaMemcpyToSymbol(fur::tile_stats, zero, sizeof(zero)));
}
#endif
