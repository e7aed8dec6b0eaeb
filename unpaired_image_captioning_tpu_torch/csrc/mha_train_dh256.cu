// The training attention's kernels of bucket 256, head widths 132..256
// (mha_train_impl.cuh; the design and the entry points are in
// mha_train.cu).
#include "mha_train_impl.cuh"

namespace uic {
namespace mha {
template int fwd<256>(const Attn&, float*, float*, cudaStream_t);
template int bwd<256>(const Attn&, const float*, const float*, const float*,
                      float*, float*, float*, float*, cudaStream_t);
}  // namespace mha
}  // namespace uic
