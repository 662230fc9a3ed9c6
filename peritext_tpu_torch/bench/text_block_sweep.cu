// The text-phase kernel of csrc/text_phase.cu at a block size the caller
// picks, for bench/text_block_sweep.py: the production library launches the
// size threads_for(cap) picks.  Built with -I peritext_tpu_torch/csrc.

#include "text_phase.cu"

namespace {

template <int NT>
int blocks_per_sm(int cap) {
  const size_t smem = smem_bytes(cap);
  int blocks = 0;
  if (set_attributes<NT>(smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, text_phase_kernel<NT>, NT, smem) !=
          cudaSuccess) {
    return -1;
  }
  return blocks;
}

}  // namespace

// Blocks of ``threads`` threads resident per SM at capacity ``cap`` (-1 on
// error or an unsupported block size).
extern "C" int pt_sweep_blocks_per_sm(int cap, int threads) {
  switch (threads) {
    case 128: return blocks_per_sm<128>(cap);
    case 256: return blocks_per_sm<256>(cap);
    case 512: return blocks_per_sm<512>(cap);
    case 1024: return blocks_per_sm<1024>(cap);
    default: return -1;
  }
}

// pt_text_phase with the block size given: 128, 256, 512 or 1024.
extern "C" int pt_sweep_text_phase(
    const void* ec_in, const void* ea_in, const void* dl_in, const void* ch_in,
    const void* len_in, const void* ops, int num_ops, const void* ranks,
    int num_ranks, const void* char_buf, int buf_len, void* ec_out,
    void* ea_out, void* dl_out, void* ch_out, void* oi_out, void* len_out,
    int replicas, int cap, int threads, void* stream) {
  return static_cast<int>(launch_threads(threads, ec_in, ea_in, dl_in, ch_in, len_in, ops,
                                         num_ops, ranks, num_ranks, char_buf, buf_len, ec_out,
                                         ea_out, dl_out, ch_out, oi_out, len_out, replicas, cap,
                                         stream));
}

// The block size the production library launches at capacity ``cap``.
extern "C" int pt_sweep_threads_for(int cap) { return threads_for(cap); }
