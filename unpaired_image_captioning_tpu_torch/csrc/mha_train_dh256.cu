// The training attention's kernels of bucket 256, head widths 129..256
// and, in column chunks of 256, every wider one
// (mha_train_impl.cuh; the design and the entry points are in
// mha_train.cu).
#include "mha_train_impl.cuh"

namespace uic {
namespace mha {
template int fwd<256>(const Attn&, void*, float*, cudaStream_t);
template int bwd<256>(const Attn&, const void*, const void*, const float*,
                      void*, void*, void*, float*, cudaStream_t);
}  // namespace mha
}  // namespace uic
