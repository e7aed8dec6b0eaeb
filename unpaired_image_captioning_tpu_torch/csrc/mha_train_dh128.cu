// The training attention's kernels of bucket 128, head widths 65..128
// (mha_train_impl.cuh; the design and the entry points are in
// mha_train.cu).
#include "mha_train_impl.cuh"

namespace uic {
namespace mha {
template int fwd<128>(const Attn&, void*, float*, cudaStream_t);
template int bwd<128>(const Attn&, const void*, const void*, const float*,
                      void*, void*, void*, void*, size_t,
                      cudaStream_t);
}  // namespace mha
}  // namespace uic
