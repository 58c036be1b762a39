"""AMP op lists: the port's own copy of ``mxnet_tpu/contrib/amp/lists.py``
(reference: ``python/mxnet/contrib/amp/lists/symbol_fp16.py``).

Three policies over registered op names:

* ``LOW_PRECISION_OPS`` — matrix-unit-bound ops (the tensor cores on the
  card) that should consume the low-precision dtype (matmul/conv
  families); inputs are cast down.
* ``FP32_OPS`` — numerically sensitive ops (norm statistics, exp/log-space
  reductions, losses) kept in fp32; low-precision float inputs are cast up.
* ``WIDEST_OPS`` — multi-input elementwise ops where mixed float inputs are
  promoted to the widest float dtype present (reference WIDEST_TYPE_CASTS).

Everything else runs in whatever dtype its inputs already carry (the reference's
FP16_FP32_FUNCS: dtype-agnostic).
"""

LOW_PRECISION_OPS = {
    "FullyConnected", "Convolution", "Deconvolution", "dot", "batch_dot",
    "matmul", "RNN", "_linalg_gemm", "_linalg_gemm2",
}

FP32_OPS = {
    "BatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm", "L2Normalization",
    "LRN", "norm", "moments", "softmax", "log_softmax", "softmin",
    "SoftmaxActivation", "SoftmaxOutput", "softmax_cross_entropy", "CTCLoss",
    "LinearRegressionOutput", "LogisticRegressionOutput", "MAERegressionOutput",
    "exp", "expm1", "log", "log1p", "log2", "log10", "logsumexp",
    "erf", "erfinv", "gamma", "gammaln", "digamma", "rsqrt", "rcbrt",
    "reciprocal", "square", "sqrt", "cbrt", "sum", "mean", "prod", "nansum",
    "nanprod", "cumsum", "smooth_l1", "svd", "_linalg_potrf", "_linalg_potri",
    "_linalg_trsm", "_linalg_trmm", "_linalg_det", "_linalg_slogdet",
    "_linalg_syevd", "_linalg_inverse", "_linalg_sumlogdiag", "_linalg_gelqf",
    "_linalg_syrk",
}

WIDEST_OPS = {
    "add_n", "concat", "stack", "broadcast_add", "broadcast_sub",
    "broadcast_mul", "broadcast_div", "broadcast_mod", "broadcast_power",
    "broadcast_maximum", "broadcast_minimum", "broadcast_hypot", "where",
}
