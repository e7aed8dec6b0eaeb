// The training attention's kernels of bucket 32, head widths 1..32
// (mha_train_impl.cuh; the design and the entry points are in
// mha_train.cu).
#include "mha_train_impl.cuh"

namespace uic {
namespace mha {
template int fwd<32>(const Attn&, void*, float*, cudaStream_t);
template int bwd<32>(const Attn&, const void*, const void*, const float*,
                      void*, void*, void*, void*, size_t,
                      cudaStream_t);
}  // namespace mha
}  // namespace uic
