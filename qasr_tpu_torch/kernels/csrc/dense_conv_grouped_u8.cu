// dense_conv_grouped_u8: the uint8-operand instantiations of Kernel 8's
// grouped form (dense_conv_grouped.cu holds the code and the C entry),
// compiled in an nvcc process of their own so that the build's slowest
// source is split in two.
#define QASR_DCG_U8
#include "dense_conv_grouped.cu"
