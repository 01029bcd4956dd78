// What the bucket passes of csrc/fused_gat.cu and csrc/ell_edge.cu share: the
// table of per-bucket pointers that travels to a kernel by value, how a
// thread finds its bucket, virtual row, lane and feature tile, the
// store-or-combine rule for rows that are split into several virtual rows,
// and the host code that fills the table and shapes a launch.
//
// Every name here has internal linkage: each source is compiled into a
// library of its own.

#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

// The per-bucket arrays that every entry point takes first, in launch order
// (widest bucket first), and how it hands them on: row_ids[i] and valid[i]
// (rows[i],) int32, nbr[i] and edge_id[i] (rows[i] * widths[i],) int32.
#define GAB_TABLE_PARAMS                                                   \
  const void *const *row_ids, const void *const *nbr,                      \
      const void *const *edge_id, const void *const *valid,                \
      const int64_t *rows, const int32_t *widths, int n_buckets
#define GAB_TABLE_ARGS row_ids, nbr, edge_id, valid, rows, widths, n_buckets

namespace {

constexpr int kMaxBuckets = 8;
constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

struct Bucket {
  const int32_t* row_ids;  // (rows,)
  const int32_t* nbr;      // (rows * width,)
  const int32_t* edge_id;  // (rows * width,) edge of each slot; pads hold ne
  const int32_t* valid;    // (rows,) real slots of each virtual row
  int64_t rows;
  int32_t width;
  int32_t first_block;     // of this bucket inside one tile's blocks
  int32_t lg;              // log2 lanes a row
};

struct Table {
  Bucket b[kMaxBuckets];
  int32_t n;
  int32_t blocks_per_tile;
  int32_t tiles;
};

// Where a thread works: bucket, virtual row, lane of the row's group, tile.
struct Pos {
  int bucket;
  int64_t r;
  int gl;
  int64_t tile;
  bool live;  // r is a row of the bucket
};

__device__ __forceinline__ Pos locate(const Table& tab, int lg) {
  Pos p;
  p.tile = blockIdx.x / tab.blocks_per_tile;
  const int32_t blk = blockIdx.x % tab.blocks_per_tile;
  int i = 0;
  while (i + 1 < tab.n && blk >= tab.b[i + 1].first_block) ++i;
  p.bucket = i;
  p.r = (static_cast<int64_t>(blk - tab.b[i].first_block) * kThreads +
         threadIdx.x) >> lg;
  p.gl = threadIdx.x & ((1 << lg) - 1);
  p.live = p.r < tab.b[i].rows;
  return p;
}

template <typename V> __device__ __forceinline__ V zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void axpy(float& acc, float a, float v) {
  acc = fmaf(a, v, acc);
}
__device__ __forceinline__ void axpy(float4& acc, float a, const float4& v) {
  acc.x = fmaf(a, v.x, acc.x);
  acc.y = fmaf(a, v.y, acc.y);
  acc.z = fmaf(a, v.z, acc.z);
  acc.w = fmaf(a, v.w, acc.w);
}

__device__ __forceinline__ float dot(float a, float b) { return a * b; }
__device__ __forceinline__ float dot(const float4& a, const float4& b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

__device__ __forceinline__ float dot_acc(float acc, float a, float b) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ float dot_acc(float acc, const float4& a,
                                         const float4& b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

// Store, or add where several writers share the address.
template <typename V>
__device__ __forceinline__ void put(V* dst, const V& v, bool add) {
  if (add) {
    atomicAdd(dst, v);
  } else {
    *dst = v;
  }
}

// Sum over the 2^lg lanes of a group; every lane of the warp takes part.
__device__ __forceinline__ float group_sum(float v, int lg) {
  for (int o = (1 << lg) >> 1; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

// Adds, over the 2^LG lanes of a group, the 2^CHUNK_LG partial sums that each
// lane holds, one per slot, and leaves every slot's total in one lane: a
// transposing butterfly. At step s a lane keeps the even or the odd half of
// its values, by bit s of its lane number, and hands the other half to the
// lane across that bit, so the values halve while the lanes summed double.
// After T = min(LG, CHUNK_LG) steps d[i] is the group's total for slot
// i 2^T + (gl mod 2^T), for i < 2^(CHUNK_LG - T). With more lanes than slots
// the remaining bits are summed in place and every lane holds slot
// gl mod 2^CHUNK_LG. Every lane of the warp takes part.
template <int LG, int CHUNK_LG>
__device__ __forceinline__ void transpose_sum(float (&d)[1 << CHUNK_LG],
                                              int gl) {
  constexpr int T = LG < CHUNK_LG ? LG : CHUNK_LG;
#pragma unroll
  for (int s = 0; s < T; ++s) {
    const bool odd = ((gl >> s) & 1) != 0;
#pragma unroll
    for (int i = 0; i < (1 << (CHUNK_LG - s - 1)); ++i) {
      const float mine = odd ? d[2 * i + 1] : d[2 * i];
      const float theirs = odd ? d[2 * i] : d[2 * i + 1];
      d[i] = mine + __shfl_xor_sync(kFullMask, theirs, 1 << s);
    }
  }
#pragma unroll
  for (int s = T; s < LG; ++s) {
    d[0] += __shfl_xor_sync(kFullMask, d[0], 1 << s);
  }
}

// max into *addr for floats of any sign: non-negative floats order like
// signed integers, negative ones in reverse like unsigned integers. -0 is
// turned into +0 first, so that it takes the integer route of its value.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  v += 0.0f;
  if (v >= 0.0f) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// min into *addr, the mirror of atomic_max_float: the least non-negative
// float is the least signed integer, the least negative float the greatest
// unsigned one. -0 is taken as +0.
__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  v += 0.0f;
  if (v >= 0.0f) {
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// Fills the table for groups of 2^lg lanes, or of 2^bucket_lg(width) lanes
// in each bucket where bucket_lg is given, and `tiles` feature tiles;
// returns the grid size, or 0 and an error code in *err.
int64_t fill_table(Table* tab, GAB_TABLE_PARAMS, int lg, int64_t tiles,
                   cudaError_t* err, int (*bucket_lg)(int32_t) = nullptr) {
  *err = cudaErrorInvalidValue;
  if (n_buckets <= 0 || n_buckets > kMaxBuckets || tiles <= 0) return 0;
  *tab = Table{};
  tab->n = n_buckets;
  int64_t blocks = 0;
  for (int i = 0; i < n_buckets; ++i) {
    if (rows[i] <= 0 || widths[i] <= 0) return 0;
    tab->b[i].row_ids = static_cast<const int32_t*>(row_ids[i]);
    tab->b[i].nbr = static_cast<const int32_t*>(nbr[i]);
    tab->b[i].edge_id = static_cast<const int32_t*>(edge_id[i]);
    tab->b[i].valid = static_cast<const int32_t*>(valid[i]);
    tab->b[i].rows = rows[i];
    tab->b[i].width = widths[i];
    tab->b[i].first_block = static_cast<int32_t>(blocks);
    tab->b[i].lg = bucket_lg != nullptr ? bucket_lg(widths[i]) : lg;
    const int64_t rows_per_block = kThreads >> tab->b[i].lg;
    blocks += (rows[i] + rows_per_block - 1) / rows_per_block;
    if (blocks > 0x7fffffff) {
      *err = cudaErrorInvalidConfiguration;
      return 0;
    }
  }
  if (blocks * tiles > 0x7fffffff) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  tab->blocks_per_tile = static_cast<int32_t>(blocks);
  tab->tiles = static_cast<int32_t>(tiles);
  *err = cudaSuccess;
  return blocks * tiles;
}

// Lanes per row (as a power of two, at most 2^max_lg: a lane then owns several
// columns of a tile) and tiles for a wide pass over f_v columns of V in tiles
// of tile_v.
bool wide_shape(int64_t f_v, int tile_v, int max_lg, int* lg, int64_t* tiles) {
  if (f_v <= 0 || tile_v <= 0 || tile_v > 32) return false;
  *lg = 0;
  while (*lg < max_lg && (1 << *lg) < tile_v) ++*lg;
  *tiles = (f_v + tile_v - 1) / tile_v;
  return true;
}

// What a wide pass settles before it launches.
struct WidePlan {
  Table tab;
  int64_t f_v;  // columns of V
  int lg;       // log2 lanes per row
  dim3 grid;
};

// Checks the shape of a wide pass, fills its table and selects `device`;
// returns the first CUDA error.
cudaError_t plan_wide(WidePlan* p, GAB_TABLE_PARAMS, int64_t f, int tile_v,
                      int vec, int device, int max_lg = 5) {
  if (vec && f % 4 != 0) return cudaErrorInvalidValue;
  p->f_v = vec ? f / 4 : f;
  int64_t tiles;
  if (!wide_shape(p->f_v, tile_v, max_lg, &p->lg, &tiles)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err;
  const int64_t grid =
      fill_table(&p->tab, GAB_TABLE_ARGS, p->lg, tiles, &err);
  if (err != cudaSuccess) return err;
  p->grid = dim3(static_cast<unsigned>(grid));
  return cudaSetDevice(device);
}

}  // namespace
