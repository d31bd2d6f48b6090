// K1, K3, K3w and K3m (fused_pipeline.cuh's rounds kernel) at a tile of
// 32 x 32 pixels, in a translation unit of its own so that nvcc
// builds it beside the default tile's (zncc_banded.cu, fused_pipeline.cu).
// The values are the default tile's bit for bit: each window sum adds its
// taps in the same order and each pixel its planes in plane order; only
// the blocks' cut of the image, and so the halo a block stages and the
// threads a round's passes keep busy, differ.  The tile is the autotuner's
// block_rows (ops/tuning.py), the counterpart of block_rows of
// custereomatching_tpu/ops/pallas_pipeline.py:_fused_kernel and of
// pallas_zncc.py:_banded_kernel.
#include "fused_pipeline.cuh"

namespace custereo {

int run_pipeline_tile32(const PipelineCall& c) { return run_outputs<32>(c); }

}  // namespace custereo
