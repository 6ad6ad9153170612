// The sparse frame encoder's counts epilogue (hdc_encoder.cu describes it):
// its instantiations, in an object of their own so that nvcc builds them
// beside the frame-word and AM epilogues' instead of after them.
#include "hdc_encoder.cuh"

int enc_counts_launch(const EncArgs& a, size_t tab, cudaStream_t stream) {
  return enc_paths<true>(a, tab, stream);
}
