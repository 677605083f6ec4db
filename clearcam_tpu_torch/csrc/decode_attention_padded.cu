// The padded instances of the narrow widths (64, 128) of the decode-attention
// kernels in decode_attention.cuh: a head dim D below the width W that
// holds it (80, 96 and 120 on W = 128), rows W wide in shared memory with
// the dims past D zero. decode_attention_forward launches them through
// this part.

#include "decode_attention.cuh"

const decode_attention_cu::Part decode_attention_cu::padded_narrow = make_part<true>(Narrow{});
