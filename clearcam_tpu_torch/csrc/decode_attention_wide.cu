// The exact instances of the wide width (256: Qwen3-Next's attention
// blocks) of the decode-attention kernels in decode_attention.cuh.
// decode_attention_forward launches them through this part.

#include "decode_attention.cuh"

const decode_attention_cu::Part decode_attention_cu::exact_wide = make_part<false>(Wide{});
