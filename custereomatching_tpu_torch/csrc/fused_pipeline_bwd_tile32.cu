// K4 (head_rounds.cuh: camera_grad.cuh's rounds kernel with the head's
// source) at a tile of 32 x 32 pixels, in a translation unit of
// its own so that nvcc builds it beside the default tile's
// (fused_pipeline_bwd.cu).  The gradient is the default tile's bit for
// bit.  The tile is the autotuner's block_rows for the trainable backward
// (ops/tuning.py), the counterpart of block_rows of
// custereomatching_tpu/ops/pallas_pipeline.py:_fused_bwd_c_kernel.
#include "head_rounds.cuh"

namespace custereo {

cudaError_t head_rounds_tile32(const HeadRoundsCall& c) {
  return head_rounds_call<32>(c);
}

}  // namespace custereo
