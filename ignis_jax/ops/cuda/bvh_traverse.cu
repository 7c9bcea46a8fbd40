// BVH traversal on the GPU: one ray per thread, stack in local memory.
//
// Same algorithm, node record and triangle test as the XLA traversal in
// ops/bvh.py (bvh_closest / bvh_any), so the two agree lane for lane:
//   * node record: two float4 per node,
//       [min.xyz, a] [max.xyz, b]  with a, b int32 bit patterns;
//       inner node: a = left child, b = right child (b >= 1);
//       leaf:       a = first triangle row, b = -1 - count (b < 0);
//   * a popped node is re-tested against the current closest hit, a leaf
//     runs the Moller-Trumbore test of ops/intersect.py, an inner node
//     pushes the children whose boxes the ray hits, near child on top;
//   * any-hit stops at the first accepted triangle.
// Rays arrive packed as two float4 per lane, [org.xyz, tmin]
// [dir.xyz, tmax], padded to a multiple of kBlock lanes (ops/cuda_bvh.py),
// so the kernels need no bounds check.  The handlers only enqueue work on
// the stream XLA hands them.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kStackDepth = 64;  // ops/bvh.py STACK_DEPTH
constexpr int kBlock = 128;      // ops/cuda_bvh.py LANE_BLOCK
constexpr float kBigInv = 1e30f;
constexpr float kTol = -1.1920928955078125e-07f;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin, tmax;
};

__device__ __forceinline__ Ray load_ray(const float4* __restrict__ rays,
                                        int lane) {
  const float4 a = __ldg(&rays[2 * lane]);
  const float4 b = __ldg(&rays[2 * lane + 1]);
  Ray r;
  r.ox = a.x; r.oy = a.y; r.oz = a.z; r.tmin = a.w;
  r.dx = b.x; r.dy = b.y; r.dz = b.z; r.tmax = b.w;
  r.ix = r.dx == 0.0f ? kBigInv : 1.0f / r.dx;
  r.iy = r.dy == 0.0f ? kBigInv : 1.0f / r.dy;
  r.iz = r.dz == 0.0f ? kBigInv : 1.0f / r.dz;
  return r;
}

// Slab test of ops/bvh.py _slab: returns the entry distance, `hit` says
// whether [near, far] is non-empty within [tmin, tmax].
__device__ __forceinline__ float slab(const Ray& r, float4 lo, float4 hi,
                                      float tmax, bool* hit) {
  const float t0x = (lo.x - r.ox) * r.ix, t1x = (hi.x - r.ox) * r.ix;
  const float t0y = (lo.y - r.oy) * r.iy, t1y = (hi.y - r.oy) * r.iy;
  const float t0z = (lo.z - r.oz) * r.iz, t1z = (hi.z - r.oz) * r.iz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                         fminf(t0z, t1z));
  const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                         fmaxf(t0z, t1z));
  const float near = fmaxf(tn, r.tmin);
  const float far = fminf(tf, tmax);
  *hit = near <= far;
  return near;
}

// Moller-Trumbore of ops/bvh.py _mt_row for triangle `row`; true when the
// hit lies in [tmin, tmax].
__device__ __forceinline__ bool tri_test(const Ray& r,
                                         const float* __restrict__ v0,
                                         const float* __restrict__ e1,
                                         const float* __restrict__ e2,
                                         int row, float tmax, float* t,
                                         float* u, float* v) {
  const float ax = __ldg(&v0[3 * row]), ay = __ldg(&v0[3 * row + 1]),
              az = __ldg(&v0[3 * row + 2]);
  const float bx = __ldg(&e1[3 * row]), by = __ldg(&e1[3 * row + 1]),
              bz = __ldg(&e1[3 * row + 2]);
  const float cx = __ldg(&e2[3 * row]), cy = __ldg(&e2[3 * row + 1]),
              cz = __ldg(&e2[3 * row + 2]);
  // tn = e1 x e2, c = v0 - o, q = d x c
  const float nx = by * cz - bz * cy, ny = bz * cx - bx * cz,
              nz = bx * cy - by * cx;
  const float qx0 = ax - r.ox, qy0 = ay - r.oy, qz0 = az - r.oz;
  const float rx = r.dy * qz0 - r.dz * qy0, ry = r.dz * qx0 - r.dx * qz0,
              rz = r.dx * qy0 - r.dy * qx0;
  const float det = nx * r.dx + ny * r.dy + nz * r.dz;
  const float inv_det = det == 0.0f ? 0.0f : 1.0f / det;
  const float uu = -(rx * cx + ry * cy + rz * cz) * inv_det;
  const float vv = (rx * bx + ry * by + rz * bz) * inv_det;
  const float ww = 1.0f - uu - vv;
  const float tt = (qx0 * nx + qy0 * ny + qz0 * nz) * inv_det;
  *t = tt;
  *u = fmaxf(uu, 0.0f);
  *v = fmaxf(vv, 0.0f);
  return det != 0.0f && uu >= kTol && vv >= kTol && ww >= kTol &&
         tt >= r.tmin && tt <= tmax;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
    traverse(const float4* __restrict__ rays, const float4* __restrict__ nodes,
             const float* __restrict__ v0, const float* __restrict__ e1,
             const float* __restrict__ e2, const int32_t* __restrict__ to_orig,
             const uint8_t* __restrict__ mask, int32_t has_mask,
             float* __restrict__ t_out, float* __restrict__ u_out,
             float* __restrict__ v_out, int32_t* __restrict__ prim_out) {
  const int lane = blockIdx.x * kBlock + threadIdx.x;
  const Ray r = load_ray(rays, lane);
  float best_t = r.tmax, best_u = 0.0f, best_v = 0.0f;
  int best_i = -1;
  int stack[kStackDepth];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const int node = stack[--sp];
    const float4 lo = __ldg(&nodes[2 * node]);
    const float4 hi = __ldg(&nodes[2 * node + 1]);
    bool box_hit;
    slab(r, lo, hi, best_t, &box_hit);
    if (!box_hit) continue;
    const int a = __float_as_int(lo.w);
    const int b = __float_as_int(hi.w);
    if (b < 0) {  // leaf: rows [a, a + count)
      const int count = -1 - b;
      for (int k = 0; k < count; ++k) {
        const int row = a + k;
        if (has_mask && !__ldg(&mask[row])) continue;
        float t, u, v;
        if (tri_test(r, v0, e1, e2, row, best_t, &t, &u, &v) && t < best_t) {
          best_t = t; best_u = u; best_v = v; best_i = row;
          if (kAnyHit) break;
        }
      }
      if (kAnyHit && best_i >= 0) break;
      continue;
    }
    const float4 llo = __ldg(&nodes[2 * a]), lhi = __ldg(&nodes[2 * a + 1]);
    const float4 rlo = __ldg(&nodes[2 * b]), rhi = __ldg(&nodes[2 * b + 1]);
    bool lhit, rhit;
    const float lnear = slab(r, llo, lhi, best_t, &lhit);
    const float rnear = slab(r, rlo, rhi, best_t, &rhit);
    const bool left_first = lnear <= rnear;
    const int first = left_first ? a : b;
    const int second = left_first ? b : a;
    const bool first_hit = left_first ? lhit : rhit;
    const bool second_hit = left_first ? rhit : lhit;
    // the build bounds the tree depth below kStackDepth (ops/bvh.py), so
    // these guards only keep a corrupt table from writing out of bounds
    if (second_hit && sp < kStackDepth) stack[sp++] = second;
    if (first_hit && sp < kStackDepth) stack[sp++] = first;
  }
  if (kAnyHit) {
    prim_out[lane] = best_i >= 0 ? 1 : 0;
    return;
  }
  t_out[lane] = best_t;
  u_out[lane] = best_u;
  v_out[lane] = best_v;
  prim_out[lane] = best_i >= 0 ? __ldg(&to_orig[best_i]) : -1;
}

ffi::Error launch_status() {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

int64_t lanes_of(const ffi::Buffer<ffi::F32>& rays) {
  return rays.dimensions()[0];
}

ffi::Error ClosestImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> rays,
                       ffi::Buffer<ffi::F32> nodes, ffi::Buffer<ffi::F32> v0,
                       ffi::Buffer<ffi::F32> e1, ffi::Buffer<ffi::F32> e2,
                       ffi::Buffer<ffi::S32> to_orig,
                       ffi::Buffer<ffi::U8> mask, int32_t has_mask,
                       ffi::ResultBuffer<ffi::F32> t,
                       ffi::ResultBuffer<ffi::F32> u,
                       ffi::ResultBuffer<ffi::F32> v,
                       ffi::ResultBuffer<ffi::S32> prim) {
  const int64_t n = lanes_of(rays);
  if (n % kBlock != 0)
    return ffi::Error::InvalidArgument("ray count must be a multiple of 128");
  if (n == 0) return ffi::Error::Success();
  traverse<false><<<n / kBlock, kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(rays.typed_data()),
      reinterpret_cast<const float4*>(nodes.typed_data()), v0.typed_data(),
      e1.typed_data(), e2.typed_data(), to_orig.typed_data(),
      mask.typed_data(), has_mask, t->typed_data(), u->typed_data(),
      v->typed_data(), prim->typed_data());
  return launch_status();
}

ffi::Error AnyImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> rays,
                   ffi::Buffer<ffi::F32> nodes, ffi::Buffer<ffi::F32> v0,
                   ffi::Buffer<ffi::F32> e1, ffi::Buffer<ffi::F32> e2,
                   ffi::Buffer<ffi::S32> to_orig, ffi::Buffer<ffi::U8> mask,
                   int32_t has_mask, ffi::ResultBuffer<ffi::S32> occluded) {
  const int64_t n = lanes_of(rays);
  if (n % kBlock != 0)
    return ffi::Error::InvalidArgument("ray count must be a multiple of 128");
  if (n == 0) return ffi::Error::Success();
  traverse<true><<<n / kBlock, kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(rays.typed_data()),
      reinterpret_cast<const float4*>(nodes.typed_data()), v0.typed_data(),
      e1.typed_data(), e2.typed_data(), to_orig.typed_data(),
      mask.typed_data(), has_mask, nullptr, nullptr, nullptr,
      occluded->typed_data());
  return launch_status();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(IgnisBvhClosest, ClosestImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // rays
                                  .Arg<ffi::Buffer<ffi::F32>>()  // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()  // v0
                                  .Arg<ffi::Buffer<ffi::F32>>()  // e1
                                  .Arg<ffi::Buffer<ffi::F32>>()  // e2
                                  .Arg<ffi::Buffer<ffi::S32>>()  // to_orig
                                  .Arg<ffi::Buffer<ffi::U8>>()   // mask
                                  .Attr<int32_t>("has_mask")
                                  .Ret<ffi::Buffer<ffi::F32>>()  // t
                                  .Ret<ffi::Buffer<ffi::F32>>()  // u
                                  .Ret<ffi::Buffer<ffi::F32>>()  // v
                                  .Ret<ffi::Buffer<ffi::S32>>());  // prim

XLA_FFI_DEFINE_HANDLER_SYMBOL(IgnisBvhAny, AnyImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()  // rays
                                  .Arg<ffi::Buffer<ffi::F32>>()  // nodes
                                  .Arg<ffi::Buffer<ffi::F32>>()  // v0
                                  .Arg<ffi::Buffer<ffi::F32>>()  // e1
                                  .Arg<ffi::Buffer<ffi::F32>>()  // e2
                                  .Arg<ffi::Buffer<ffi::S32>>()  // to_orig
                                  .Arg<ffi::Buffer<ffi::U8>>()   // mask
                                  .Attr<int32_t>("has_mask")
                                  .Ret<ffi::Buffer<ffi::S32>>());  // occluded
