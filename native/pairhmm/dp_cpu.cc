// Host build of the fused pair-HMM DP (dp_core.h): the same per-pair code
// the CUDA kernel runs, with one lane per pair, registered as the XLA FFI
// target "dindel_pairhmm_dp" on the CPU platform.  It lets the CPU test
// suite run the kernel's arithmetic and wiring against hmm/batch._dp_xla.
//
// Build (hmm/fused.py does this at first use):
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC \
//       -I <jax.ffi.include_dir()> -o libdindel_pairhmm_cpu.so dp_cpu.cc

#include <vector>

#include "xla/ffi/api/ffi.h"

#define DP_FN inline
#define DP_SYNC() ((void)0)
#include "dp_core.h"

namespace ffi = xla::ffi;
using namespace dindel_dp;

namespace {

ffi::Error DpCpu(ffi::Buffer<ffi::S32> hap_len, ffi::Buffer<ffi::S32> read_len,
                 ffi::Buffer<ffi::S32> b_mid, ffi::Buffer<ffi::U8> read_codes,
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
  const float* sc = scalars.typed_data();
  const Scal s{sc[0], sc[1], sc[2], sc[3], sc[4]};
  std::vector<float> sm(scratch_floats(d));
  std::vector<uint8_t> smb(scratch_bytes(d));
  for (int64_t p = 0; p < d.B; ++p)
    pair_dp(d, s, 0, 1, p, hap_len.typed_data(), read_len.typed_data(),
            b_mid.typed_data(), read_codes.typed_data(),
            hap_codes.typed_data(), eq.typed_data(), uq.typed_data(),
            lpe.typed_data(), lpn.typed_data(), amid->typed_data(),
            bmid->typed_data(), btf->typed_data(), btb->typed_data(),
            sm.data(), smb.data());
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(DindelPairhmmDpCpu, DpCpu,
                              ffi::Ffi::Bind()
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
