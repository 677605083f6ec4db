// The padded instances of the wide width (256) of the decode-attention
// kernels in decode_attention.cuh: a head dim 128 < D < 256, rows 256 wide
// in shared memory with the dims past D zero. decode_attention_forward
// launches them through this part.

#include "decode_attention.cuh"

const decode_attention_cu::Part decode_attention_cu::padded_wide = make_part<true>(Wide{});
