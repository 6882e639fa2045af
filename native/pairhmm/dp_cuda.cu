// CUDA build of the fused pair-HMM DP (dp_core.h), exposed to JAX as the
// XLA FFI target "dindel_pairhmm_dp" on the CUDA platform.
//
// One warp per (haplotype, read) pair: the warp's 32 lanes own the states
// x = lane, lane + 32, ...; the pair's DP rows live in shared memory, so the
// shifted candidate reads of a step (W[x -/+ y]) are shared-memory loads
// after a __syncwarp, and each step's backpointer bytes go out as one
// coalesced row store.  Pairs are independent, so a block is just
// kWarps pairs side by side and no block-level barrier is needed.
//
// Build (hmm/fused.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false \
//        -shared -Xcompiler -fPIC -I <jax.ffi.include_dir()> \
//        -o libdindel_pairhmm_cuda.so dp_cuda.cu

#include <cuda_runtime.h>

#include <string>

#include "xla/ffi/api/ffi.h"

#define DP_FN __device__ __forceinline__
#define DP_SYNC() __syncwarp()
#include "dp_core.h"

namespace ffi = xla::ffi;
using namespace dindel_dp;

namespace {

constexpr int kWarps = 4;  // pairs per block

__global__ void __launch_bounds__(kWarps * 32)
    dp_kernel(Dims d, const float* __restrict__ scal,
              const int32_t* __restrict__ hap_len,
              const int32_t* __restrict__ read_len,
              const int32_t* __restrict__ b_mid,
              const uint8_t* __restrict__ rc, const uint8_t* __restrict__ hc,
              const float* __restrict__ eq, const float* __restrict__ uq,
              const float* __restrict__ lpe, const float* __restrict__ lpn,
              float* amid, float* bmid, uint8_t* btf, uint8_t* btb) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t nf = scratch_floats(d);
  float* sm = smem + warp * nf;
  uint8_t* smb = reinterpret_cast<uint8_t*>(smem + kWarps * nf) +
                 warp * scratch_bytes(d);
  const Scal s{scal[0], scal[1], scal[2], scal[3], scal[4]};
  for (int64_t p = (int64_t)blockIdx.x * kWarps + warp; p < d.B;
       p += (int64_t)gridDim.x * kWarps)
    pair_dp(d, s, lane, 32, p, hap_len, read_len, b_mid, rc, hc, eq, uq,
            lpe, lpn, amid, bmid, btf, btb, sm, smb);
}

ffi::Error DpCuda(cudaStream_t stream, ffi::Buffer<ffi::S32> hap_len,
                  ffi::Buffer<ffi::S32> read_len, ffi::Buffer<ffi::S32> b_mid,
                  ffi::Buffer<ffi::U8> read_codes,
                  ffi::Buffer<ffi::U8> hap_codes, ffi::Buffer<ffi::F32> eq,
                  ffi::Buffer<ffi::F32> uq, ffi::Buffer<ffi::F32> lpe,
                  ffi::Buffer<ffi::F32> lpn, ffi::Buffer<ffi::F32> scalars,
                  ffi::ResultBuffer<ffi::F32> amid,
                  ffi::ResultBuffer<ffi::F32> bmid,
                  ffi::ResultBuffer<ffi::U8> btf,
                  ffi::ResultBuffer<ffi::U8> btb, int32_t num_t) {
  Dims d;
  d.B = read_codes.dimensions()[0];
  d.L = (int)read_codes.dimensions()[1];
  d.H = (int)hap_codes.dimensions()[1];
  d.S = (int)lpe.dimensions()[1];
  d.numT = num_t;
  if (d.S != d.H + 2 || num_t < 2 || num_t > 15)
    return ffi::Error::InvalidArgument("dindel_pairhmm_dp: bad shapes");
  if (d.B == 0) return ffi::Error::Success();
  const size_t smem =
      kWarps * (scratch_floats(d) * sizeof(float) + scratch_bytes(d));
  cudaError_t err = cudaFuncSetAttribute(
      dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("dindel_pairhmm_dp: ") +
                                cudaGetErrorString(err));
  const int64_t blocks = (d.B + kWarps - 1) / kWarps;
  const unsigned grid = (unsigned)(blocks < (1 << 30) ? blocks : (1 << 30));
  dp_kernel<<<grid, kWarps * 32, smem, stream>>>(
      d, scalars.typed_data(), hap_len.typed_data(),
      read_len.typed_data(), b_mid.typed_data(), read_codes.typed_data(),
      hap_codes.typed_data(), eq.typed_data(), uq.typed_data(),
      lpe.typed_data(), lpn.typed_data(), amid->typed_data(),
      bmid->typed_data(), btf->typed_data(), btb->typed_data());
  err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("dindel_pairhmm_dp: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(DindelPairhmmDpCuda, DpCuda,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Attr<int32_t>("num_t"));
