"""The SameDiff op cases the port is held to, numpy only (no JAX, no
TensorFlow): ``test_torch_sd_ops.py`` runs each through the JAX package
and the port on the CPU, ``test_torch_cuda.py`` through the port on the
card against the port on the host.

``CASES`` are (namespace, op, args, kwargs, bars); ``RANDOM_CASES`` draw
from ``K``, a seeded random source (a JAX key on one side, a
``torch.Generator`` on the other); ``BP_CASES`` and ``ASSERT_CASES``
hold the ``bp`` and ``assert`` namespaces.
"""

import math

import numpy as np

R = np.random.default_rng(0)
A = R.standard_normal((4, 5)).astype(np.float32)
B = R.standard_normal((4, 5)).astype(np.float32)
M = R.standard_normal((5, 3)).astype(np.float32)
SQ = (R.standard_normal((4, 4)) + 4 * np.eye(4)).astype(np.float32)
_L = R.standard_normal((4, 4)).astype(np.float32)
SPD = (_L @ _L.T + 4 * np.eye(4)).astype(np.float32)
LOW = np.tril(SQ).astype(np.float32)
V = R.standard_normal(7).astype(np.float32)
V8 = R.standard_normal(8).astype(np.float32)
POS = (np.abs(A) + 0.5).astype(np.float32)
UNIT = (np.tanh(A) * 0.9).astype(np.float32)
GE1 = (1.0 + np.abs(A)).astype(np.float32)
PROB = R.uniform(0.05, 0.95, (4, 5)).astype(np.float32)
SOFT = (np.exp(A) / np.exp(A).sum(-1, keepdims=True)).astype(np.float32)
I32 = np.arange(12, dtype=np.int32).reshape(3, 4)
J32 = (np.arange(12, dtype=np.int32).reshape(3, 4) % 5 + 1)
IDS = np.array([0, 2, 1, 2], np.int32)
IMG = R.random((2, 8, 8, 3)).astype(np.float32)
IMG1 = R.random((2, 6, 6, 2)).astype(np.float32)
X3 = R.standard_normal((2, 6, 3)).astype(np.float32)          # (B, T, D)
X5 = R.standard_normal((2, 4, 4, 4, 2)).astype(np.float32)    # NDHWC
CPLX = (R.standard_normal(8) + 1j * R.standard_normal(8)).astype(np.complex64)
SIG = R.standard_normal(64).astype(np.float32)
ONEHOT = np.eye(5, dtype=np.float32)[[0, 3, 1, 4]]
LAB01 = (R.random((4, 5)) > 0.5).astype(np.float32)
SIGNS = np.array([1.0, -1.0, 1.0, -1.0], np.float32)
BOXES = np.array([[0.0, 0.0, 0.5, 0.5], [0.05, 0.05, 0.55, 0.55],
                  [0.5, 0.5, 1.0, 1.0], [0.0, 0.5, 0.5, 1.0],
                  [0.52, 0.48, 1.0, 0.98]], np.float32)
SCORES = np.array([0.9, 0.8, 0.7, 0.6, 0.85], np.float32)


class _Key:
    """The random-source argument: a JAX key on the reference's side, a
    seeded ``torch.Generator`` on the port's."""

    def __init__(self, seed=0):
        self.seed = seed


K = _Key()


CASES = []


def c(ns, op, *args, _atol=1e-5, _rtol=1e-5, _dtype=True, **kw):
    CASES.append((ns, op, args, kw, {"atol": _atol, "rtol": _rtol,
                                     "dtype": _dtype}))


# ---------------------------------------------------------- sweeps
# unary elementwise: (namespace, op, input)
UNARY = {
    "math": {"abs": A, "exp": A, "log": POS, "log1p": POS, "sqrt": POS,
             "square": A, "sin": A, "cos": A, "tan": UNIT, "tanh": A,
             "sinh": A, "cosh": A, "asin": UNIT, "acos": UNIT, "atan": A,
             "erf": A, "floor": A * 3, "ceil": A * 3,
             "round": np.array([0.5, 1.5, 2.5, -0.5, -1.5, 1.2], np.float32),
             "sign": A, "reciprocal": POS, "neg": A, "isnan": A,
             "isinf": A, "asinh": A, "acosh": GE1, "atanh": UNIT,
             "expm1": A, "log2": POS, "log10": POS, "rsqrt": POS,
             "cbrt": A, "exp2": A, "erfc": A, "erfinv": UNIT, "lgamma": POS,
             "digamma": POS, "entr": PROB, "logit": PROB, "expit": A,
             "is_finite": np.array([1.0, np.inf, np.nan], np.float32),
             "is_nan": np.array([1.0, np.inf, np.nan], np.float32),
             "is_inf": np.array([1.0, np.inf, np.nan], np.float32),
             "is_numeric_tensor": A, "is_max": A, "logical_not": A > 0,
             "trunc": A * 3,
             "rint": np.array([0.5, 1.5, 2.5, -0.5, -2.5], np.float32),
             "deg2rad": A, "rad2deg": A, "frexp": A * 10,
             "step": A, "sinc": A, "signbit": A, "fabs": A,
             "i0": A, "i0e": A, "i1": A, "i1e": A, "gamma_fn": A * 2,
             "factorial": np.array([0.0, 1.0, 3.0, 4.5], np.float32),
             "ndtr": A, "ndtri": PROB, "log_ndtr": A, "spence": POS * 2,
             "real": CPLX, "imag": CPLX, "conj": CPLX, "angle": CPLX,
             "complex_abs": CPLX, "ediff1d": V, "cube": A,
             "rational_tanh": A, "rectified_tanh": A,
             "is_non_decreasing": np.sort(V), "is_strictly_increasing": V,
             "zero_fraction": np.array([0.0, 1.0, 0.0, 2.0], np.float32),
             "cot": UNIT + 2, "sec": UNIT, "csc": UNIT + 2,
             "log1mexp": -POS, "to_degrees": A, "to_radians": A,
             "modf": A * 3},
    "nn": {"relu": A, "relu6": A * 4, "sigmoid": A, "tanh": A,
           "softmax": A, "log_softmax": A, "elu": A, "selu": A, "gelu": A,
           "leaky_relu": A, "softplus": A, "swish": A, "silu": A,
           "mish": A, "hard_sigmoid": A * 4, "softsign": A,
           "hard_tanh": A * 2, "hard_swish": A * 4, "log_sigmoid": A,
           "glu": A[:, :4], "celu": A, "gelu_tanh": A, "gelu_exact": A,
           "hard_shrink": A, "soft_shrink": A, "tanh_shrink": A,
           "swiglu": A[:, :4], "crelu": A, "precise_gelu": A,
           "thresholded_relu": A * 2, "l2_normalize": A,
           "softmax_with_temperature": A, "dropout": A},
    "base": {"zeros_like": A, "ones_like": A, "identity": A,
             "shape_of": A, "size": A, "rank": A, "ravel": A,
             "atleast_1d": np.float32(2.0), "atleast_2d": V,
             "atleast_3d": A, "iamax": V, "iamin": V,
             "invert_permutation": np.array([2, 0, 3, 1], np.int32),
             "stop_gradient": A, "eye_like": A,
             "nan_to_num": np.array([np.nan, 1.0, np.inf, -np.inf],
                                    np.float32),
             "hashcode": A, "diag_part": SQ, "trace": SQ},
    "linalg": {"cholesky": SPD, "inv": SQ, "pinv": A, "det": SQ,
               "eigvalsh": SPD, "expm": SQ * 0.1, "matrix_transpose": A,
               "matrix_diag": V, "matrix_diag_part": SQ, "logdet": SPD,
               "matrix_inverse": SQ, "matrix_determinant": SQ,
               "adjoint": A, "cond": SQ, "svdvals": A, "norm_nuclear": A,
               "slogdet": SQ, "log_matrix_determinant": SQ},
    "image": {"flip_left_right": IMG, "flip_up_down": IMG,
              "rgb_to_grayscale": IMG, "per_image_standardization": IMG,
              "rgb_to_hsv": IMG, "hsv_to_rgb": IMG, "rgb_to_yiq": IMG,
              "yiq_to_rgb": IMG, "rgb_to_yuv": IMG, "yuv_to_rgb": IMG,
              "sobel_edges": IMG, "image_gradients": IMG,
              "grayscale_to_rgb": IMG[..., :1], "rgb_to_bgr": IMG,
              "total_variation": IMG},
    "cnn": {"global_avg_pooling": IMG, "global_max_pooling": IMG},
    "bitwise": {"invert": I32 - 5, "bit_count": I32 - 5},
    "loss": {"l2_loss": A},
    "fft": {"fftshift": V8, "ifftshift": V8},
}
for ns, ops in UNARY.items():
    for op, x in ops.items():
        c(ns, op, x, _atol=2e-5, _rtol=2e-5)

BINARY = {
    "math": {"add": (A, B), "sub": (A, B), "mul": (A, B), "div": (A, POS),
             "pow": (POS, B), "maximum": (A, B), "minimum": (A, B),
             "atan2": (A, B), "logaddexp": (A, B), "logaddexp2": (A, B),
             "xlogy": (POS, POS), "igamma": (POS, POS),
             "igammac": (POS, POS), "zeta": (GE1 + 0.5, POS),
             "polygamma": (1, POS), "mod": (I32, 5), "fmod": (A * 3, B),
             "floor_div": (I32 - 6, 5), "floor_mod": (A * 3, POS),
             "truncate_div": (A * 3, POS), "rdiv": (POS, A),
             "rsub": (A, B), "remainder": (I32 - 6, 4),
             "eq": (I32, 5), "neq": (I32, 5), "gt": (A, B), "gte": (A, B),
             "lt": (A, B), "lte": (A, B), "is_close": (A, A + 1e-9),
             "logical_and": (A > 0, B > 0), "logical_or": (A > 0, B > 0),
             "logical_xor": (A > 0, B > 0), "cosine_similarity": (A, B),
             "cosine_distance": (A, B), "euclidean_distance": (A, B),
             "manhattan_distance": (A, B),
             "hamming_distance": (I32 % 3, J32 % 3),
             "jaccard_distance": (POS, PROB),
             "squared_difference": (A, B), "copysign": (A, B),
             "heaviside": (np.array([-1.0, 0.0, 2.0], np.float32), 0.5),
             "hypot": (A, B), "ldexp": (A, np.array(3, np.int32)),
             "betaln": (POS, POS), "rel_entr": (PROB, SOFT),
             "kl_div_elem": (PROB, SOFT), "nextafter": (A, B),
             "gcd": (I32, J32), "lcm": (I32, J32), "fmax": (A, B),
             "fmin": (A, B), "float_power": (POS, B), "divmod": (A * 3, POS),
             "relative_error": (A, B), "realdiv": (A, POS),
             "truncate_mod": (A * 3, POS), "squared_subtract": (A, B),
             "floordiv": (I32, 3), "multigammaln": (POS + 2, 2),
             "eps": (A, A + 1e-7), "all_euclidean": (A, B),
             "all_manhattan": (A, B), "all_cosine_similarity": (A, B),
             "all_cosine_distance": (A, B), "all_dot": (A, B),
             "all_hamming": (I32 % 2, J32 % 2), "all_jaccard": (POS, PROB),
             "merge_max_index": (A, B), "complex": (A, B)},
    "bitwise": {"and_": (I32, J32), "or_": (I32, J32), "xor": (I32, J32),
                "left_shift": (I32 - 5, 3), "right_shift": (I32 - 5, 1),
                "bits_hamming_distance": (I32, J32),
                "cyclic_shift_left": (I32 - 5, 3),
                "cyclic_shift_right": (I32 - 5, 3),
                "bit_rotl": (I32 + 1000, 5), "bit_rotr": (I32 + 1000, 5),
                "set_bit": (I32, 4), "clear_bit": (I32, 1),
                "toggle_bit": (I32, 2), "test_bit": (I32 - 5, 1)},
    "loss": {"softmax_cross_entropy": (SOFT, A),
             "sparse_softmax_cross_entropy": (IDS, A),
             "sigmoid_cross_entropy": (LAB01, A),
             "mean_squared_error": (A, B), "absolute_difference": (A, B),
             "cosine_distance": (A, B), "log_loss": (LAB01, PROB),
             "huber_loss": (A, B), "hinge_loss": (LAB01, A),
             "squared_hinge_loss": (LAB01, A), "poisson_loss": (POS, POS),
             "kl_divergence": (SOFT, PROB), "smooth_l1_loss": (A, B),
             "focal_loss": (LAB01, A), "log_poisson_loss": (POS, A),
             "log_poisson": (POS, A), "dice_loss": (LAB01, PROB),
             "log_cosh_loss": (A, B), "quantile_loss": (A, B),
             "mean_pairwise_squared_error": (A, B),
             "multi_label_loss": (LAB01, A), "mae_loss": (A, B),
             "mape_loss": (POS, PROB), "msle_loss": (POS, PROB),
             "wasserstein_loss": (A, B), "fmeasure_loss": (LAB01, PROB)},
    "base": {"mmul": (A, M), "matmul": (A, M), "dot": (V, V),
             "vdot": (A, B), "outer": (V, V), "kron": (SQ[:2, :2], SQ),
             "cross": (A[:, :3], B[:, :3]), "merge_add": (A, B),
             "merge_avg": (A, B), "merge_max": (A, B), "add_n": (A, B),
             "accumulate_n": (A, B), "identity_n": (A, B),
             "array_equal": (A, A.copy()), "isin": (I32, [1, 5, 7]),
             "full_like": (A, 3.0), "assign": (A, 2.0),
             "expand_dims": (A, 1), "repeat": (A, 2),
             "hstack": (A, B), "vstack": (A, B), "dstack": (A, B),
             "column_stack": (V, V), "parallel_stack": (A, B),
             "concat": (A, B), "stack": (A, B), "tile": (A, (2, 1)),
             "broadcast_to": (V, (3, 7)), "reshape": (A, (5, 4)),
             "squeeze": (A[:, None], 1), "swapaxes": (A, 0, 1)},
    "linalg": {"solve": (SQ, M[:4]), "mmul": (A, M),
               "matrix_power": (SQ * 0.3, 3), "khatri_rao": (A, B),
               "block_diag": (SQ, A), "multi_dot": (A, M),
               "triangular_solve": (LOW, M[:4]),
               "matrix_triangular_solve": (LOW, M[:4]),
               "cho_solve": (np.linalg.cholesky(SPD).astype(np.float32),
                             M[:4]),
               "cholesky_solve": (np.linalg.cholesky(SPD).astype(
                   np.float32), M[:4]),
               "lu_solve": (SQ, M[:4]), "toeplitz": (V,),
               "vander": (V[:4],), "tri": (4,),
               "matrix_band_part": (SQ, 1, 0)},
}
for ns, ops in BINARY.items():
    for op, args in ops.items():
        c(ns, op, *args, _atol=3e-5, _rtol=3e-5)

# reductions with axes
for op in ("sum", "mean", "prod", "max", "min", "std", "variance", "norm1",
           "norm2", "norm_max", "squared_norm", "logsumexp", "reduce_sum",
           "reduce_mean", "reduce_max", "reduce_min", "reduce_prod",
           "reduce_logsumexp", "standard_deviation", "nanmax", "nanmin",
           "nansum", "nanmean", "nanstd", "nanvar"):
    c("base", op, A)
    c("base", op, A, 1, _atol=2e-5, _rtol=2e-5)
for op in ("sum", "prod", "max", "min", "reduce_sum", "reduce_prod"):
    c("base", op, I32, 0)                       # integer reductions: int32
c("base", "sum", A, 0, keepdims=True)
c("base", "mean", I32)                          # int mean: float32
c("base", "variance", A, 0, ddof=1)
c("base", "nanmean", np.array([1.0, np.nan, 3.0], np.float32))
for op in ("any", "all", "reduce_any", "reduce_all"):
    c("base", op, A > 0)
    c("base", op, A > 0, 1)
for op in ("count_nonzero", "count_zero"):
    c("base", op, np.array([0, 1, 0, 2]))
    c("base", op, I32 % 2, 1)
for op in ("argmax", "argmin"):
    c("base", op, A)
    c("base", op, A, 0)
for op in ("amax", "amin", "amean", "asum", "entropy", "log_entropy",
           "shannon_entropy"):
    c("math", op, SOFT)
    c("math", op, SOFT, 1)
c("math", "log_sum_exp", A)
c("math", "log_sum_exp", A, 1)
for op in ("cumsum", "cumprod"):
    c("base", op, V)
    c("base", op, I32, 1)
    c("math", op, A, 1)
c("math", "cummax", A, 1)
c("math", "cummin", A, 0)

# ---------------------------------------------------------- base, by hand
c("base", "permute", A, 1, 0)
c("base", "transpose", X3)
c("base", "transpose", X3, 2, 0, 1)
c("base", "unstack", A, 1)
c("base", "tear", A)
c("base", "split", A, 2)
c("base", "split", A, [1, 3], axis=1)
c("base", "split_sizes", A, (1, 3, 1), axis=1)
c("base", "pad", A, ((1, 1), (0, 2)))
c("base", "pad", A, ((1, 2), (2, 1)), mode="reflect")
c("base", "pad", A, ((1, 2), (2, 1)), mode="symmetric")
c("base", "pad", A, ((1, 2), (2, 1)), mode="edge")
c("base", "pad", A, ((1, 1), (1, 1)), value=3.0)
c("base", "mirror_pad", A, ((1, 2), (1, 2)))
c("base", "mirror_pad", A, ((1, 2), (1, 2)), mode="SYMMETRIC")
c("base", "reverse", A, 0)
c("base", "reverse_v2", A, 0, 1)
c("base", "flip", A, 1)
c("base", "roll", V, 2)
c("base", "roll", A, (1, -2), (0, 1))
c("base", "moveaxis", X3, 0, 2)
c("base", "eye", 4)
c("base", "eye", 3, 5)
c("base", "fill", (2, 3), 7.0)
c("base", "fill", (2, 3), 7)
c("base", "linspace", 0.0, 1.0, 5)
c("base", "range", 5)
c("base", "range", 1.0, 2.0, 0.25)
c("base", "meshgrid", V[:3], V[:4])
c("base", "meshgrid", V[:3], V[:4], indexing="ij")
c("base", "cast", A, "int32")
c("base", "cast", A, "bool")
c("base", "cast", I32, "float32")
c("base", "cast", A * 10, "uint8")
c("base", "size_at", A, 1)
c("base", "gather", A, [2, 0])
c("base", "gather", A, [4, 0, 5, -1], axis=1)        # fill / wrap modes
c("base", "gather_nd", A, [[0, 1], [3, 4]])
c("base", "take_nd", A, [[0, 1], [3, 4]])
c("base", "take", A, [0, 7, 19])
c("base", "take", A, [1, 0], axis=1)
c("base", "scatter_add", V, [1, 1, 3], [1.0, 2.0, 3.0])
c("base", "scatter_sub", V, [1, 1, 3], [1.0, 2.0, 3.0])
c("base", "scatter_update", V, [0, 2], [9.0, 8.0])
c("base", "scatter_mul", V, [0, 2, 2], [2.0, 3.0, 4.0])
c("base", "scatter_div", V, [0, 2], [2.0, 4.0])
c("base", "scatter_max", V, [0, 1], [100.0, -100.0])
c("base", "scatter_min", V, [0, 1], [100.0, -100.0])
c("base", "scatter_nd", [[1], [3]], np.ones((2, 5), np.float32), (5, 5))
c("base", "scatter_nd_add", A, [[0, 1], [3, 4]], np.array([1.0, 2.0],
                                                         np.float32))
c("base", "scatter_nd_sub", A, [[0, 1], [3, 4]], np.array([1.0, 2.0],
                                                         np.float32))
c("base", "scatter_nd_update", A, [[0, 1], [3, 4]], np.array([1.0, 2.0],
                                                            np.float32))
c("base", "slice", A, (1, 2), (2, 3))
c("base", "slice", A, (3, 4), (2, 3))                  # clamped starts
c("base", "strided_slice", A, (0, 1), (4, 5), (2, 2))
c("base", "strided_slice", A, (3, 4), (0, 0), (-1, -2))
c("base", "where", A > 0, A, B)
c("base", "where", A > 0)
c("base", "boolean_mask", A, A[:, 0] > 0, 4)
c("base", "take_along_axis", A, np.argsort(A, 1), 1)
c("base", "take_along_axis", A, np.array([[0], [7], [-1], [2]]), 1)
c("base", "put_along_axis", A, np.argmax(A, 1)[:, None], 0.0, 1)
c("base", "one_hot", IDS, 3)
c("base", "one_hot", IDS, 4, 2.0, -1.0)
c("base", "searchsorted", np.sort(V), 0.0)
c("base", "searchsorted", np.sort(V), V, side="right")
c("base", "diag", V)
c("base", "diag", SQ)
c("base", "tril", SQ)
c("base", "triu", SQ, 1)
c("base", "segment_sum", V[:4], [0, 0, 1, 2], 3)
c("base", "segment_prod", V[:4], [0, 0, 1, 2], 3)
c("base", "segment_max", np.arange(4.0), [0, 0, 1, 1], 2)
c("base", "segment_min", A, [0, 0, 1, 1], 3)
c("base", "segment_mean", np.arange(4.0), [0, 0, 1, 1], 2)
c("base", "unsorted_segment_sum", np.arange(4.0), [1, 0, 1, 0], 2)
c("base", "unsorted_segment_max", A, [1, 0, 1, 0], 3)
c("base", "unsorted_segment_min", A, [1, 0, 1, 0], 3)
c("base", "unsorted_segment_prod", A, [1, 0, 1, 0], 2)
c("base", "unsorted_segment_mean", A, [1, 0, 1, 0], 2)
c("base", "unsorted_segment_sqrt_n", A, [1, 0, 1, 0], 2)
c("base", "sort", V)
c("base", "sort", V, descending=True)
c("base", "argsort", V)
c("base", "top_k", A, 3)
c("base", "unique", np.array([3, 1, 3, 2, 3], np.int32), 5)
c("base", "unique_with_counts", np.array([3, 1, 3, 2, 3], np.int32), 4)
c("base", "in_top_k", A, [0, 1, 2, 3], 2)
c("base", "batch_mmul", np.stack([A, A]), np.stack([M, M]))
c("base", "batch_mmul", A, A, transpose_b=True)
c("base", "batch_mmul", A, A, transpose_a=True)
c("base", "tensor_mmul", A, M, 1)
c("base", "tensor_mmul", X3, M[:3], ((2,), (0,)))
c("base", "einsum", "ij,jk->ik", A, M)
c("base", "space_to_depth", IMG[:, :, :, :2], 2)
c("base", "depth_to_space", IMG1[..., :2].repeat(2, -1), 2)
c("base", "space_to_batch", IMG1, 2)
c("base", "space_to_batch", IMG1, 2, ((1, 1), (0, 2)))
c("base", "batch_to_space", IMG1.repeat(4, 0), 2)
c("base", "batch_to_space", IMG1.repeat(4, 0), 2, ((1, 1), (2, 0)))
c("base", "space_to_batch_nd", IMG1, (2, 3), ((0, 0), (0, 0)))
c("base", "batch_to_space_nd", IMG1.repeat(6, 0), (2, 3),
  ((0, 1), (1, 0)))
c("base", "dynamic_partition", A, np.array([0, 1, 0, 1]), 2)
c("base", "dynamic_stitch", [np.array([0, 2]), np.array([1, 3])],
  [A[:2], A[2:]])
c("base", "sequence_mask", np.array([1, 3, 2]), 4)
c("base", "sequence_mask", np.array([1, 3, 2]))
c("base", "reverse_sequence", X3, np.array([3, 5]))
c("base", "confusion_matrix", np.array([0, 1, 2, 2]),
  np.array([0, 2, 2, 1]), 3)
c("base", "clip_by_value", A, -0.5, 0.5)
c("base", "clip_by_norm", A, 1.0)
c("base", "clip_by_norm", A, 1.0, 1)
c("base", "clip_by_global_norm", [A, B], 1.0)
c("base", "bincount", IDS, 4)
c("base", "bincount", np.array([0, 5, 1, 1]), 3)       # ids past length
c("base", "histogram_fixed_width", A, (-1.0, 1.0), 5)
c("base", "histogram", A, 4)
c("base", "histogram", A, 4, range=(-1.0, 1.0))
c("base", "digitize", A, np.array([-1.0, 0.0, 1.0], np.float32))
c("base", "digitize", A, np.array([1.0, 0.0, -1.0], np.float32))
c("base", "bucketize", A, np.array([-1.0, 0.0, 1.0], np.float32))
c("base", "percentile", A, 30.0)
c("base", "percentile", A, 70.0, axis=1)
c("base", "quantile", A, 0.25)
c("base", "quantile", A, 0.6, axis=0)
c("base", "median", A)
c("base", "median", A, axis=1)
c("base", "ptp", A)
c("base", "ptp", A, axis=0)
c("base", "average", A)
c("base", "average", A, np.arange(5, dtype=np.float32), axis=1)
c("base", "nonzero", np.array([0, 3, 0, 5, 1]), 4)
c("base", "tril_indices", 4)
c("base", "triu_indices", 4, 1)
c("base", "batch_gather", A, np.array([[0, 1], [2, 2], [4, 0], [1, 3]]))
c("base", "matrix_set_diag", A, V[:4])
c("base", "replace_where", A, 0.0, "lt", 0.0)
c("base", "replace_where", A, B, "abs_gt", 1.0)
c("base", "compare_and_set", A, float(A[0, 0]), 7.0)
c("base", "check_numerics", A)
c("base", "nth_element", A, 2)
c("base", "nth_element", A, 1, reverse=True)
c("base", "bitcast", A, "int32")
c("base", "broadcast_shapes", (3, 1), (1, 4))
c("base", "broadcast_dynamic_shape", np.array([3, 1]), np.array([1, 4]))
c("base", "sparse_to_dense", np.array([[0, 1], [2, 3]]), (3, 4),
  np.array([5.0, 6.0], np.float32))
c("base", "sparse_to_dense", np.array([0, 2]), (4,),
  np.array([5, 6], np.int32), -1)
c("base", "sufficient_statistics", A, (0,))
c("base", "sufficient_statistics", A, 1, np.float32(0.5))
c("base", "mode", np.array([[1, 2, 2, 3], [4, 4, 1, 1]], np.float32))
c("base", "array_equal", A, B)
c("base", "array_equal", A, A[:2])
c("base", "setdiff1d", np.array([1, 2, 3, 4, 5], np.int32), [2, 4], 4)
c("base", "list_diff", np.array([1, 2, 3, 4, 5], np.int32), [2, 4], 3)
c("base", "intersect1d", np.array([1, 2, 3, 4], np.int32),
  np.array([2, 4, 6], np.int32), 3)
c("base", "union1d", np.array([1, 2, 3], np.int32),
  np.array([2, 5], np.int32), 5)
c("base", "unravel_index", np.array([0, 5, 11]), (3, 4))
c("base", "ravel_multi_index", (np.array([0, 1, 2]), np.array([3, 0, 9])),
  (3, 4))
c("base", "compare_and_bitpack", R.standard_normal((2, 16)).astype(
    np.float32), 0.0)
for mode in range(6):
    c("base", "choose", I32, mode, 5)

# ---------------------------------------------------------- math, by hand
c("math", "clip_by_value", A, -0.5, 0.5)
c("math", "matmul", A, M)
c("math", "tensordot", A, M, 1)
c("math", "einsum", "ij,kj->ik", A, B)
c("math", "match_condition", A, "gt", 0.0)
c("math", "match_condition_count", A, "lte", 0.0)
c("math", "standardize", A)
c("math", "standardize", A, 0)
c("math", "clip_by_avg_norm", A, 0.5)
c("math", "clip_by_avg_norm", A, 0.5, 1)
c("math", "moving_average", V, 3)
c("math", "diff", V)
c("math", "diff", A, 2, 0)
c("math", "interp", np.linspace(-1, 3, 9).astype(np.float32),
  np.array([0.0, 1.0, 2.0], np.float32), np.array([1.0, 3.0, 2.0],
                                                  np.float32))
c("math", "unwrap", np.array([0.0, 3.0, 6.5, 0.2, -3.5], np.float32))
c("math", "convolve", V, V[:3])
c("math", "convolve", V, V[:3], mode="same")
c("math", "convolve", V[:3], V, mode="valid")
c("math", "correlate", V, V[:3])
c("math", "correlate", V, V[:3], mode="full")
c("math", "correlate", V[:3], V, mode="full")
c("math", "trapz", A)
c("math", "trapz", A, np.arange(5, dtype=np.float32) ** 2)
c("math", "polyval", [1.0, -2.0, 3.0], A)
c("math", "select", [A > 0.5, A < -0.5], [A, B], 0.0)
c("math", "lerp", A, B, 0.3)
c("math", "axpy", 2.0, A, B)
c("math", "first_index", A, "gt", 0.5)
c("math", "first_index", A, "gt", 100.0)
c("math", "last_index", A, "lt", 0.0)
c("math", "betainc", POS, POS + 1, PROB, _atol=1e-5, _rtol=1e-4)
c("math", "fft", CPLX)
c("math", "ifft", CPLX)
c("math", "rfft", V8)
c("math", "irfft", np.fft.rfft(V8).astype(np.complex64))

# ---------------------------------------------------------- nn, by hand
c("nn", "linear", A, M)
c("nn", "linear", A, M, V[:3])
c("nn", "layer_norm", A, V[:5], V[:5] * 0.5)
c("nn", "layer_norm_no_bias", A, V[:5])
c("nn", "rms_norm", A, V[:5])
c("nn", "batch_norm", A, A.mean(0), A.var(0), V[:5], V[1:6])
c("nn", "conv2d", IMG, R.standard_normal((3, 3, 3, 4)).astype(np.float32))
c("nn", "conv2d", IMG, R.standard_normal((2, 2, 3, 4)).astype(np.float32),
  (2, 2), "VALID")
c("nn", "max_pool2d", IMG)
c("nn", "max_pool2d", IMG, (3, 3), (2, 2), "SAME")
c("nn", "avg_pool2d", IMG)
c("nn", "embedding_lookup", A, IDS)
c("nn", "embedding_lookup", A, np.array([[0, 1], [3, 2]]), 0.5)
c("nn", "leaky_relu", A, 0.3)
c("nn", "elu", A, 0.5)
c("nn", "celu", A, 0.7)
c("nn", "softmax", A, 0)
_WQ = R.standard_normal((2, 4, 3)).astype(np.float32)
c("nn", "multi_head_dot_product_attention", X3, X3, X3, _WQ, _WQ * 0.5,
  _WQ * 2, R.standard_normal((3, 8)).astype(np.float32))
_Q4 = R.standard_normal((2, 5, 2, 4)).astype(np.float32)
c("nn", "dot_product_attention", _Q4, _Q4 * 0.5, _Q4)
c("nn", "dot_product_attention", _Q4, _Q4, _Q4,
  np.tril(np.ones((5, 5), bool))[None, None])
c("nn", "scaled_dot_product_attention", _Q4, _Q4 * 0.7, _Q4)
c("nn", "prelu", A, 0.2)
c("nn", "normalize_moments", np.float32(5.0), A.sum(0), (A * A).sum(0))
c("nn", "moments", A, (0,))
c("nn", "bias_add", A, V[:5])
c("nn", "pad", A, ((1, 1), (2, 0)), 1.5)
c("nn", "threshold", A, 0.2, -1.0)
c("nn", "lp_normalize", A)
c("nn", "lp_normalize", A, 1, 0)
c("nn", "pairwise_distance", A, B)
c("nn", "group_norm", IMG1.repeat(2, -1), V[:4], V[1:5], 2)
c("nn", "instance_norm", IMG, V[:3], V[1:4])
c("nn", "relu_layer", A, M, V[:3])
c("nn", "xw_plus_b", A, M, V[:3])
c("nn", "fake_quant_with_min_max_args", A * 4)
c("nn", "fake_quant_with_min_max_args", A, -1.0, 1.5, 4, True)
c("nn", "fake_quant_with_min_max_vars", A * 4, -3.0, 3.0)
c("nn", "quantize", A, 0.05, 3)
c("nn", "quantize", A, 0.05, 0, signed=True)
c("nn", "dequantize", np.array([[0, 10, 255]], np.uint8), 0.1, 3)

# ---------------------------------------------------------- loss, by hand
c("loss", "huber_loss", A, B, 0.5)
c("loss", "weighted_cross_entropy_with_logits", LAB01, A, 2.0)
c("loss", "triplet_margin_loss", A, B, A * 0.5)
c("loss", "margin_ranking_loss", V[:4], V[1:5], SIGNS)
c("loss", "cosine_embedding_loss", A, B, SIGNS, 0.1)
c("loss", "mixture_density_loss",
  R.standard_normal((4, 2)).astype(np.float32),
  R.standard_normal((4, 3 * 2 + 2)).astype(np.float32), 2)
_LP = R.standard_normal((2, 6, 4)).astype(np.float32)
c("loss", "ctc_loss", _LP, np.array([[1, 2, 0], [3, 3, 1]], np.int32),
  np.array([6, 5], np.int32), np.array([2, 3], np.int32), _atol=1e-4,
  _rtol=1e-4)

# ---------------------------------------------------------- linalg
c("linalg", "qr", SQ)
c("linalg", "svd", A)
c("linalg", "eigh", SPD)
c("linalg", "lstsq", A.T.copy(), V[:5])
c("linalg", "lstsq", A, V[:4])
c("linalg", "matrix_rank", A)
c("linalg", "norm", A)
c("linalg", "norm", A, 1, 1)
c("linalg", "norm", A, "fro", (0, 1))
c("linalg", "norm", V, np.inf)
c("linalg", "lu", SQ)
c("linalg", "lu_factor", SQ)
c("linalg", "cho_factor", SPD)
c("linalg", "cho_factor", SPD, lower=False)
c("linalg", "sqrtm", SPD, _atol=1e-4, _rtol=1e-4)
c("linalg", "tensorinv", SQ.reshape(2, 2, 2, 2), 2, _atol=1e-4)
c("linalg", "tensorsolve", SQ.reshape(2, 2, 4), V[:4].reshape(2, 2),
  _atol=1e-4)
c("linalg", "orth", A @ M @ M.T, _atol=1e-4, _rtol=1e-4)
c("linalg", "null_space", A[:2], _atol=1e-4, _rtol=1e-4)
c("linalg", "batched_gemm", np.stack([A, B]), np.stack([M, M]))
c("linalg", "batched_gemm", np.stack([A, B]), np.stack([A, B]),
  transpose_b=True, alpha=0.5, beta=2.0,
  c=np.ones((2, 4, 4), np.float32))

# ---------------------------------------------------------- cnn
_W1 = R.standard_normal((3, 3, 4)).astype(np.float32)        # WIO
_W2 = R.standard_normal((3, 3, 3, 4)).astype(np.float32)     # HWIO
_W3 = R.standard_normal((2, 2, 2, 2, 3)).astype(np.float32)  # DHWIO
_DW = R.standard_normal((3, 3, 1, 3)).astype(np.float32)
_PW = R.standard_normal((1, 1, 3, 5)).astype(np.float32)
_WT2 = R.standard_normal((3, 3, 3, 2)).astype(np.float32)
c("cnn", "conv1d", X3, _W1)
c("cnn", "conv1d", X3, _W1, 2, "VALID", 1)
c("cnn", "conv1d", X3, _W1, 1, "SAME", 2)
c("cnn", "conv2d", IMG, _W2)
c("cnn", "conv2d", IMG, _W2, (2, 2), "SAME")
c("cnn", "conv2d", IMG, _W2, (1, 2), "VALID", (2, 1))
c("cnn", "conv2d", IMG, _W2, (1, 1), ((1, 0), (2, 1)))
c("cnn", "atrous_conv2d", IMG, _W2, 2)
c("cnn", "conv3d", X5, _W3)
c("cnn", "conv3d", X5, _W3, (2, 2, 2), "VALID")
c("cnn", "depthwise_conv2d", IMG, _DW)
c("cnn", "depthwise_conv2d", IMG, _DW, (2, 2), "VALID")
c("cnn", "separable_conv2d", IMG, _DW, _PW)
for op in ("deconv2d", "conv2d_transpose"):
    c("cnn", op, IMG, _WT2)
    c("cnn", op, IMG, _WT2, (2, 2), "VALID")
    c("cnn", op, IMG, _WT2, (1, 1), "SAME")
for op in ("deconv1d", "conv1d_transpose"):
    c("cnn", op, X3, _W1[:, :, :2])
    c("cnn", op, X3, _W1[:, :, :2], 3, "VALID")
for op in ("deconv3d", "conv3d_transpose"):
    c("cnn", op, X5, _W3[..., :2, :])
c("cnn", "max_pooling1d", X3, 2)
c("cnn", "max_pooling1d", X3, 3, 2, "SAME")
c("cnn", "max_pooling2d", IMG, 2)
c("cnn", "max_pooling2d", IMG, (3, 3), (2, 2), "SAME")
c("cnn", "max_pooling3d", X5, 2)
c("cnn", "avg_pooling1d", X3, 2)
c("cnn", "avg_pooling2d", IMG, (3, 3), (2, 2), "SAME")
c("cnn", "avg_pooling2d", IMG, 2)
c("cnn", "avg_pooling3d", X5, 2, 1, "SAME")
c("cnn", "upsampling1d", X3, 2)
c("cnn", "upsampling2d", IMG, 2)
c("cnn", "upsampling3d", X5, 2)
c("cnn", "local_response_normalization", IMG.repeat(4, -1), 2)
c("cnn", "local_response_normalization", IMG, 1, 2.0, 0.5, 0.75)
c("cnn", "im2col", IMG, 3, 2)
c("cnn", "col2im", R.standard_normal((2, 6, 7, 3 * 3 * 2)).astype(
    np.float32), (2, 8, 8, 3), 3, 2)
c("cnn", "batch_norm", IMG, IMG.mean((0, 1, 2)), IMG.var((0, 1, 2)),
  V[:3], V[1:4])
c("cnn", "adaptive_avg_pooling2d", IMG, 3, 2)
c("cnn", "adaptive_max_pooling2d", IMG, 3, 5)
c("cnn", "max_pool_with_argmax", IMG, 2)
c("cnn", "max_pool_with_argmax", IMG, 3, 2, "SAME")
c("cnn", "lp_pool2d", IMG, 2)
c("cnn", "pnorm_pool2d", IMG, 2, 1, 3.0)
c("cnn", "pixel_shuffle", IMG1.repeat(2, -1), 2)
c("cnn", "pixel_unshuffle", IMG, 2)
_F2 = R.standard_normal((3, 3, 3)).astype(np.float32) * 0.1
c("cnn", "dilation2d", IMG, _F2)
c("cnn", "dilation2d", IMG, _F2, (2, 2), (1, 1), "SAME")
c("cnn", "dilation2d", IMG, _F2, (1, 1), (2, 2), "VALID")
c("cnn", "erosion2d", IMG, _F2)

# ---------------------------------------------------------- rnn
_H = 3
_XR = R.standard_normal((2, 5, 4)).astype(np.float32)
_H0 = R.standard_normal((2, _H)).astype(np.float32)
_WI = R.standard_normal((4, 4 * _H)).astype(np.float32) * 0.5
_WH = R.standard_normal((_H, 4 * _H)).astype(np.float32) * 0.5
_BL = R.standard_normal(4 * _H).astype(np.float32)
_GI, _GH, _GB = _WI[:, :3 * _H], _WH[:, :3 * _H], _BL[:3 * _H]
_SI, _SH, _SB = _WI[:, :_H], _WH[:, :_H], _BL[:_H]
for op in ("lstm_cell", "lstm_block_cell"):
    c("rnn", op, _XR[:, 0], _H0, _H0 * 0.5, _WI, _WH, _BL)
c("rnn", "gru_cell", _XR[:, 0], _H0, _GI, _GH, _GB)
c("rnn", "simple_rnn_cell", _XR[:, 0], _H0, _SI, _SH, _SB)
for op in ("lstm_layer", "lstm_block"):
    c("rnn", op, _XR, _H0, _WI, _WH, _BL)
for op in ("gru_layer", "gru"):
    c("rnn", op, _XR, _H0, _GI, _GH, _GB)
for op in ("simple_rnn_layer", "dynamic_rnn", "static_rnn"):
    c("rnn", op, _XR, _H0, _SI, _SH, _SB)
for op in ("bidirectional_lstm_layer", "bidirectional_dynamic_rnn"):
    c("rnn", op, _XR, _H0, _H0 * 0.5, _WI, _WH, _BL, _WI * 0.5, _WH, _BL)
c("rnn", "bidirectional_gru_layer", _XR, _H0, _H0, _GI, _GH, _GB, _GI,
  _GH * 0.5, _GB)
_XS = R.standard_normal((2, 5, 3)).astype(np.float32)
_WS = R.standard_normal((3, 9)).astype(np.float32) * 0.5
_BS = R.standard_normal(6).astype(np.float32)
c("rnn", "sru_cell", _XS[:, 0], _H0, _WS, _BS)
c("rnn", "sru", _XS, _H0, _WS, _BS)

# ---------------------------------------------------------- image
c("image", "resize_bilinear", IMG, 5, 11, _atol=3e-5)
c("image", "resize_bilinear", IMG, 16, 12, _atol=3e-5)
c("image", "resize_nearest", IMG, 5, 11)
c("image", "resize_nearest", IMG, 16, 12)
c("image", "resize_bicubic", IMG, 5, 11, _atol=3e-5)
c("image", "resize_bicubic", IMG, 13, 16, _atol=3e-5)
for m in ("bilinear", "nearest", "bicubic", "lanczos3", "lanczos5", "area"):
    c("image", "image_resize", IMG, 4, 4, m, _atol=3e-5)
    c("image", "image_resize", IMG, 5, 11, m, _atol=3e-5)
c("image", "resize_area", IMG, 4, 2)
c("image", "resize_area", IMG, 5, 3, _atol=3e-5)
c("image", "rot90", IMG)
c("image", "rot90", IMG, 3)
c("image", "adjust_brightness", IMG, 0.1)
c("image", "adjust_contrast", IMG, 1.5)
c("image", "adjust_contrast_v2", IMG, 0.5)
c("image", "adjust_gamma", IMG, 2.0, 0.5)
c("image", "adjust_hue", IMG, 0.3)
c("image", "adjust_hue", IMG, -0.45)
c("image", "adjust_saturation", IMG, 0.4)
c("image", "adjust_saturation", IMG, 1.7)
c("image", "central_crop", IMG, 0.5)
c("image", "extract_patches", IMG, 3, 2)
c("image", "pad_to_bounding_box", IMG, 1, 2, 10, 12)
c("image", "crop_to_bounding_box", IMG, 1, 2, 5, 4)
c("image", "non_max_suppression", BOXES, SCORES, 4)
c("image", "non_max_suppression", BOXES, SCORES, 5, 0.3, 0.65)
c("image", "non_max_suppression_with_scores", BOXES, SCORES, 4)
_OV = R.random((5, 5)).astype(np.float32)
c("image", "non_max_suppression_overlaps", _OV, SCORES, 4, 0.5)
c("image", "crop_and_resize", IMG, BOXES[:3], np.array([0, 1, 0]), (3, 4))
c("image", "crop_and_resize", IMG, BOXES[:2] * 1.5 - 0.2,
  np.array([1, 0]), (1, 5), 0.5)
c("image", "draw_bounding_boxes", IMG, np.stack([BOXES[:2], BOXES[2:4]]))
c("image", "draw_bounding_boxes", IMG, np.stack([BOXES[:2], BOXES[2:4]]),
  np.eye(3, dtype=np.float32)[:2])
_MAT = np.array([[0.9, -0.2, 1.5], [0.1, 1.1, -0.7]], np.float32)
c("image", "affine_transform", IMG, _MAT)
c("image", "affine_transform", IMG[0], _MAT, 0, 0.3)
c("image", "rotate", IMG, 0.4, _atol=3e-5)
c("image", "rotate", IMG[0], math.pi / 2, _atol=3e-5)
c("image", "translate", IMG, 1.5, -2.0)
c("image", "translate", IMG, 2.0, 1.0, 0, 0.2)

# ---------------------------------------------------------- fft, signal
c("fft", "fft", CPLX)
c("fft", "fft", V8, 10)
c("fft", "ifft", CPLX, None, 0)
c("fft", "rfft", V8)
c("fft", "rfft", A, 6, 0)
c("fft", "irfft", np.fft.rfft(V8).astype(np.complex64))
c("fft", "irfft", np.fft.rfft(V8).astype(np.complex64), 8)
c("fft", "hfft", CPLX[:5])
c("fft", "ihfft", V8)
for op in ("fft2", "ifft2", "fftn", "ifftn"):
    c("fft", op, A)
c("fft", "fftn", X3, (0, 2))
c("fft", "rfft2", A)
c("fft", "rfftn", X3)
c("fft", "irfft2", np.fft.rfft2(A).astype(np.complex64))
c("fft", "irfftn", np.fft.rfftn(X3).astype(np.complex64))
c("fft", "fftshift", A, (0,))
c("fft", "ifftshift", A, (1,))
c("fft", "fftfreq", 8)
c("fft", "fftfreq", 7, 0.5)
c("fft", "rfftfreq", 8, 0.25)
for w in ("hann_window", "hamming_window", "blackman_window",
          "bartlett_window"):
    c("signal", w, 16)
    c("signal", w, 9, False)
c("signal", "kaiser_window", 12)
c("signal", "kaiser_window", 9, 5.0)
c("signal", "frame", SIG, 16, 8)
c("signal", "frame", SIG[:60], 16, 8, True)
c("signal", "frame", SIG[:10], 4, 6, True, 1.0)
c("signal", "overlap_and_add", R.standard_normal((5, 16)).astype(
    np.float32), 8)
c("signal", "stft", SIG, 16, 8, _atol=5e-5, _rtol=5e-5)
c("signal", "stft", SIG, 16, 8, 32, None, True, _atol=5e-5, _rtol=5e-5)
c("signal", "istft", np.fft.rfft(R.standard_normal((7, 16))).astype(
    np.complex64), 16, 8, _atol=5e-5, _rtol=5e-5)
c("signal", "spectrogram", SIG, 16, 8, _atol=5e-5, _rtol=5e-5)
c("signal", "log_mel_spectrogram", SIG, 32, 16, 8, 8000, _atol=5e-4,
  _rtol=5e-4)
c("signal", "linear_to_mel_weight_matrix", _atol=3e-5, _rtol=3e-5)
c("signal", "linear_to_mel_weight_matrix", 10, 17, 16000, 50.0, 7000.0,
  _atol=3e-5, _rtol=3e-5)
c("signal", "mfcc", R.standard_normal((3, 20)).astype(np.float32))
c("signal", "mfcc", R.standard_normal((3, 20)).astype(np.float32), 5)

# ---------------------------------------------------------- updater
_G = A * 0.1
for op, state in (("sgd_updater", ()), ("momentum_updater", (B,)),
                  ("nesterovs_updater", (B,)), ("ada_grad_updater", (POS,)),
                  ("rms_prop_updater", (POS,)),
                  ("ada_delta_updater", (POS, POS * 0.5)),
                  ("adam_updater", (B, POS, 3)),
                  ("ada_max_updater", (B, POS, 3)),
                  ("nadam_updater", (B, POS, 2)),
                  ("ams_grad_updater", (B, POS, POS * 2, 5))):
    c("updater", op, _G, *state)
c("updater", "adam_updater", _G, B, POS, 1, lr=0.01, beta1=0.8)

# ---------------------------------------------------------- list
_TA = (np.zeros((4, 3), np.float32), np.int32(2))
_TA1 = (np.arange(12, dtype=np.float32).reshape(4, 3), np.int32(3))
c("list", "create_list", 4, (3,))
c("list", "create_list", 2, (2, 2), "int32")
c("list", "write_list", _TA, 1, V[:3])
c("list", "write_list", _TA, 9, V[:3])                  # dropped
c("list", "read_list", _TA1, 2)
c("list", "push_list", _TA, V[:3])
c("list", "push_list", (np.zeros((2, 3), np.float32), np.int32(2)), V[:3])
c("list", "stack_list", _TA1)
c("list", "unstack_list", _TA, A[:3, :3])
c("list", "gather_list", _TA1, [2, 0])
c("list", "scatter_list", _TA1, [3, 1], A[:2, :3])
c("list", "scatter_list", _TA, np.zeros((0,), np.int32),
  np.zeros((0, 3), np.float32))
c("list", "split_list", (np.zeros((3, 4), np.float32), np.int32(0)),
  np.arange(6, dtype=np.float32), [2, 4])
c("list", "size_list", _TA1)


# ----------------------------------------------------- random: moments
N = 20000
RANDOM_CASES = [
    # (ns, op, args, kw, (lo, hi) support or None)
    ("random", "uniform", (K, (N,)), {"minval": -2.0, "maxval": 3.0},
     (-2.0, 3.0)),
    ("random", "stateless_uniform", (K, (N,)), {}, (0.0, 1.0)),
    ("random", "normal", (K, (N,)), {"mean": 1.0, "stddev": 2.0}, None),
    ("random", "stateless_normal", (K, (N,)), {}, None),
    ("random", "log_normal", (K, (N,)), {"stddev": 0.5}, (0.0, None)),
    ("random", "truncated_normal", (K, (N,)), {}, (-2.0, 2.0)),
    ("random", "stateless_truncated_normal", (K, (N,)), {"stddev": 3.0},
     (-6.0, 6.0)),
    ("random", "bernoulli", (K, 0.3, (N,)), {}, (0, 1)),
    ("random", "stateless_bernoulli", (K, 0.7, (N,)), {}, (0, 1)),
    ("random", "binomial", (K, 10, 0.3, (N,)), {}, (0, 10)),
    ("random", "gamma", (K, 2.5, (N,)), {}, (0.0, None)),
    ("random", "gamma", (K, 0.4, (N,)), {}, (0.0, None)),
    ("random", "beta", (K, 2.0, 3.0, (N,)), {}, (0.0, 1.0)),
    ("random", "poisson", (K, 3.5, (N,)), {}, (0, None)),
    ("random", "exponential", (K, (N,)), {"rate": 2.0}, (0.0, None)),
    ("random", "laplace", (K, (N,)), {}, None),
    ("random", "gumbel", (K, (N,)), {}, None),
    ("random", "cauchy", (K, (N,)), {}, None),
    ("random", "randint", (K, (N,), -3, 7), {}, (-3, 6)),
    ("random", "permutation", (K, 1000), {}, (0, 999)),
    ("random", "shuffle", (K, np.arange(1000, dtype=np.float32)), {},
     (0.0, 999.0)),
    ("random", "choice", (K, np.arange(50, dtype=np.float32), (N,)), {},
     (0.0, 49.0)),
    ("random", "choice", (K, np.arange(500, dtype=np.float32), (100,)),
     {"replace": False}, (0.0, 499.0)),
    ("random", "categorical", (K, np.log(np.array(
        [0.1, 0.2, 0.7], np.float32)), (N,)), {}, (0, 2)),
    ("random", "multinomial", (K, np.log(np.array(
        [[0.5, 0.5, 0.0001], [0.1, 0.1, 0.8]], np.float32)), N), {},
     (0, 2)),
    ("random", "dirichlet", (K, np.array([1.0, 2.0, 3.0], np.float32),
                             (N // 3,)), {}, (0.0, 1.0)),
    ("random", "multivariate_normal", (K, np.array([1.0, -1.0], np.float32),
                                       SPD[:2, :2], (N // 2,)), {}, None),
    ("random", "student_t", (K, 5.0, (N,)), {}, None),
    ("random", "standard_t", (K, 8.0, (N,)), {}, None),
    ("random", "chisquare", (K, 3.0, (N,)), {}, (0.0, None)),
    ("random", "rayleigh", (K, 2.0, (N,)), {}, (0.0, None)),
    ("random", "logistic", (K, (N,)), {}, None),
    ("random", "pareto", (K, 4.0, (N,)), {}, (1.0, None)),
    ("random", "geometric", (K, 0.3, (N,)), {}, (1, None)),
    ("random", "rademacher", (K, (N,)), {}, (-1, 1)),
    ("random", "weibull", (K, (N,)), {"a": 2.0, "scale": 1.5}, (0.0, None)),
    ("random", "triangular", (K, (N,)), {"left": -1.0, "mode": 0.2,
                                         "right": 2.0}, (-1.0, 2.0)),
    ("random", "f", (K, (N,), 5.0, 12.0), {}, (0.0, None)),
    ("random", "negative_binomial", (K, (N,), 4.0, 0.4), {}, (0, None)),
    ("nn", "dropout_train", (K, np.ones((N,), np.float32), 0.3), {},
     (0.0, 1 / 0.7 + 1e-5)),
    ("nn", "alpha_dropout_train", (K, np.ones((N,), np.float32), 0.2), {},
     None),
    ("nn", "spatial_dropout_train", (K, np.ones((400, 5, 5), np.float32),
                                     0.5), {}, (0.0, 2.0)),
    ("nn", "gumbel_softmax", (K, np.zeros((N // 4, 4), np.float32), 0.5),
     {}, (0.0, 1.0)),
    ("image", "random_crop", (K, IMG, 5, 4), {}, (0.0, 1.0)),
    ("image", "random_flip_left_right", (K, np.broadcast_to(
        IMG[:1], (400,) + IMG.shape[1:]).copy()), {}, (0.0, 1.0)),
    ("image", "random_flip_up_down", (K, np.broadcast_to(
        IMG[:1], (400,) + IMG.shape[1:]).copy()), {}, (0.0, 1.0)),
    ("image", "random_brightness", (K, IMG, 0.2), {}, (-0.2, 1.2)),
    ("image", "random_contrast", (K, IMG, 0.5, 1.5), {}, (-0.5, 1.5)),
    ("image", "random_hue", (K, IMG, 0.2), {}, (0.0, 1.0)),
    ("image", "random_saturation", (K, IMG, 0.5, 1.5), {}, (0.0, 1.0)),
    ("image", "sample_distorted_bounding_box", (K, (32, 24)), {},
     (0, 32)),
]


# ----------------------------------------------------- bp ops
_XB = R.standard_normal((2, 6, 6, 3)).astype(np.float32)
# the activations of the reference's ``bp`` family (sd_ops._ACT_FWD)
ACTIVATIONS = ("relu", "relu6", "elu", "selu", "gelu", "sigmoid", "tanh",
               "softplus", "softsign", "swish", "hard_swish", "hard_sigmoid",
               "leaky_relu", "mish", "softmax", "log_softmax", "cube",
               "rational_tanh", "rectified_tanh")
BP_CASES = [(f"{n}_bp", (A, R.standard_normal(A.shape).astype(np.float32)),
             {}) for n in ACTIVATIONS]
BP_CASES += [
    ("conv1d_bp", (X3, _W1, R.standard_normal((2, 6, 4)).astype(
        np.float32)), {}),
    ("conv2d_bp", (_XB, _W2, R.standard_normal((2, 6, 6, 4)).astype(
        np.float32)), {}),
    ("conv3d_bp", (X5, _W3, R.standard_normal((2, 4, 4, 4, 3)).astype(
        np.float32)), {}),
    ("deconv1d_bp", (X3, _W1[:, :, :2], R.standard_normal(
        (2, 12, 2)).astype(np.float32)), {}),
    ("deconv2d_bp", (_XB, _WT2, R.standard_normal((2, 12, 12, 2)).astype(
        np.float32)), {}),
    ("deconv3d_bp", (X5, _W3[..., :2, :], R.standard_normal(
        (2, 8, 8, 8, 3)).astype(np.float32)), {}),
    ("depthwise_conv2d_bp", (_XB, _DW, R.standard_normal(
        (2, 6, 6, 3)).astype(np.float32)), {}),
    ("separable_conv2d_bp", (_XB, _DW, _PW, R.standard_normal(
        (2, 6, 6, 5)).astype(np.float32)), {}),
    ("max_pooling1d_bp", (X3, R.standard_normal((2, 3, 3)).astype(
        np.float32)), {"k": 2}),
    ("max_pooling2d_bp", (_XB, R.standard_normal((2, 3, 3, 3)).astype(
        np.float32)), {"k": 2}),
    ("max_pooling3d_bp", (X5, R.standard_normal((2, 2, 2, 2, 2)).astype(
        np.float32)), {"k": 2}),
    ("avg_pooling1d_bp", (X3, R.standard_normal((2, 3, 3)).astype(
        np.float32)), {"k": 2}),
    ("avg_pooling2d_bp", (_XB, R.standard_normal((2, 3, 3, 3)).astype(
        np.float32)), {"k": 2, "padding": "SAME"}),
    ("avg_pooling3d_bp", (X5, R.standard_normal((2, 2, 2, 2, 2)).astype(
        np.float32)), {"k": 2}),
    ("lp_pool2d_bp", (np.abs(_XB) + 0.1, R.standard_normal(
        (2, 3, 3, 3)).astype(np.float32)), {"k": 2}),
    ("local_response_normalization_bp", (_XB, R.standard_normal(
        _XB.shape).astype(np.float32)), {"depth_radius": 1}),
    ("im2col_bp", (_XB, R.standard_normal((2, 4, 4, 27)).astype(
        np.float32)), {"kh": 3, "kw": 3}),
    ("upsampling2d_bp", (_XB, R.standard_normal((2, 12, 12, 3)).astype(
        np.float32)), {}),
    ("pixel_shuffle_bp", (IMG1.repeat(2, -1), R.standard_normal(
        (2, 12, 12, 1)).astype(np.float32)), {"r": 2}),
    ("batch_norm_bp", (A, A.mean(0), A.var(0), V[:5], V[1:6],
                       R.standard_normal(A.shape).astype(np.float32)), {}),
    ("layer_norm_bp", (A, V[:5], R.standard_normal(A.shape).astype(
        np.float32)), {}),
    ("bias_add_bp", (A, V[:5], R.standard_normal(A.shape).astype(
        np.float32)), {}),
    ("l2_normalize_bp", (A, R.standard_normal(A.shape).astype(
        np.float32)), {}),
    ("lstm_layer_bp", (_XR, _H0, _WI, _WH, _BL, R.standard_normal(
        (2, 5, _H)).astype(np.float32)), {}),
    ("gru_layer_bp", (_XR, _H0, _GI, _GH, _GB, R.standard_normal(
        (2, 5, _H)).astype(np.float32)), {}),
    ("matmul_bp", (A, M, R.standard_normal((4, 3)).astype(np.float32)), {}),
    ("mmul_bp", (A, M, R.standard_normal((4, 3)).astype(np.float32)), {}),
]
for _n in ("sum", "mean", "max", "min", "prod", "variance", "std", "norm2",
           "logsumexp"):
    BP_CASES.append((f"reduce_{_n}_bp", (A, np.float32(1.5)), {}))
    BP_CASES.append((f"reduce_{_n}_bp", (A, V[:4]), {"axis": 1}))
BP_CASES.append(("squared_norm_bp", (A, np.float32(2.0)), {}))


# ----------------------------------------------------- assert ops
ASSERT_CASES = [
    ("assert_true", (A > -100,), (A > 0,)),
    ("assert_eq", (A, A), (A, B)),
    ("assert_neq", (A, A + 1), (A, A)),
    ("assert_gt", (A + 100, A), (A, A)),
    ("assert_gte", (A, A), (A, A + 1)),
    ("assert_lt", (A, A + 1), (A, A)),
    ("assert_lte", (A, A), (A + 1, A)),
    ("assert_finite", (A,), (np.array([1.0, np.inf], np.float32),)),
    ("assert_positive", (POS,), (A,)),
    ("assert_non_negative", (np.abs(A),), (A,)),
    ("assert_rank", (A, 2), (A, 3)),
    ("assert_shapes_equal", (A, B), (A, M)),
]




# ------------- mirrored: the inputs of test_sd_ops_r4.py, r4b.py and r5.py
_X4 = np.asarray([1.0, -2.0, 3.0, -4.0], np.float32)
c("base", "replace_where", _X4, 0.0, "lt", 0.0)
c("base", "replace_where", _X4, np.full(4, 9.0, np.float32), "gt", 2.0)
c("base", "compare_and_set", _X4, -2.0, 7.0)
_X5 = np.asarray([0.0, 3.0, 0.0, 5.0, 0.0], np.float32)
c("math", "first_index", _X5, "gt", 0.0)
c("math", "last_index", _X5, "gt", 0.0)
c("math", "first_index", _X5, "gt", 99.0)
c("math", "merge_max_index", np.asarray([1.0, 5.0], np.float32),
  np.asarray([2.0, 1.0], np.float32), np.asarray([0.0, 9.0], np.float32))
c("base", "check_numerics", np.asarray([1, 2, 3], np.int32))
_LIN = np.linspace(-3, 3, 31).astype(np.float32)
c("math", "rational_tanh", _LIN)
c("math", "rectified_tanh", _LIN)
_R0 = np.random.default_rng(0)
_PX = _R0.standard_normal((4, 6)).astype(np.float32)
_PY = _R0.standard_normal((3, 6)).astype(np.float32)
for _op in ("all_euclidean", "all_manhattan", "all_cosine_similarity",
            "all_dot"):
    c("math", _op, _PX, _PY)
c("math", "eps", np.asarray([1.0, 2.0], np.float32),
  np.asarray([1.0 + 1e-7, 3.0], np.float32))
c("math", "axpy", 2.0, np.asarray([1.0, 2.0], np.float32),
  np.asarray([1.0, 3.0], np.float32))
c("math", "lerp", 0.0, 10.0, 0.3)
c("math", "cube", np.float32(3.0))
c("nn", "fake_quant_with_min_max_args",
  np.asarray([0.0, 0.011, 3.0, 7.0, -1.0], np.float32), min=0.0, max=6.0)
c("nn", "quantize", np.asarray([0.0, 0.5, 1.0, -0.25], np.float32),
  scale=1 / 128, zero_point=128)
_R3 = np.random.default_rng(3)
_SX = _R3.standard_normal((2, 5, 4)).astype(np.float32)
_SW = _R3.standard_normal((4, 12)).astype(np.float32)
_SB = _R3.standard_normal(8).astype(np.float32)
c("rnn", "sru", _SX, np.zeros((2, 4), np.float32), _SW, _SB)
c("rnn", "simple_rnn_layer", np.ones((2, 3, 4), np.float32),
  np.zeros((2, 5), np.float32), np.full((4, 5), 0.1, np.float32),
  np.full((5, 5), 0.1, np.float32), np.zeros(5, np.float32))
_R1 = np.random.default_rng(1)
_DX = _R1.standard_normal((1, 6, 6, 2)).astype(np.float32)
_DF = _R1.standard_normal((3, 3, 2)).astype(np.float32)
c("cnn", "dilation2d", _DX, _DF, padding="VALID")
c("cnn", "erosion2d", _DX, _DF, padding="VALID")
c("cnn", "dilation2d", np.ones((1, 5, 7, 1), np.float32),
  np.zeros((3, 3, 1), np.float32), padding="SAME")
c("cnn", "dilation2d", np.arange(16, dtype=np.float32).reshape(1, 4, 4, 1),
  np.zeros((3, 3, 1), np.float32), strides=(2, 2), padding="SAME")
c("image", "non_max_suppression_overlaps",
  np.asarray([[1.0, 0.9, 0.0], [0.9, 1.0, 0.0], [0.0, 0.0, 1.0]],
             np.float32), np.asarray([0.9, 0.8, 0.7], np.float32), 3,
  overlap_threshold=0.5)
c("image", "resize_area", np.arange(16, dtype=np.float32).reshape(
    1, 4, 4, 1), 2, 2)
for _m in ("bilinear", "nearest", "bicubic", "area"):
    c("image", "image_resize", np.ones((1, 4, 4, 3), np.float32), 8, 8,
      method=_m)
c("image", "draw_bounding_boxes", np.zeros((1, 10, 10, 3), np.float32),
  np.asarray([[[0.1, 0.1, 0.5, 0.5]]], np.float32))
c("loss", "mean_pairwise_squared_error",
  np.asarray([[0.0, 1.0, 2.0]], np.float32),
  np.asarray([[1.0, 3.0, 2.0]], np.float32))
_LAB3 = np.eye(3, dtype=np.float32)
_PRE3 = np.abs(np.random.default_rng(0).random((3, 3)).astype(np.float32))
for _op in ("multi_label_loss", "mae_loss", "mape_loss", "msle_loss",
            "wasserstein_loss", "fmeasure_loss"):
    c("loss", _op, _LAB3, _PRE3)
_SBX = np.random.default_rng(0).standard_normal((2, 4, 6, 3)).astype(
    np.float32)
c("base", "space_to_batch_nd", _SBX, [2, 3], [(0, 0), (0, 0)])
c("base", "space_to_batch_nd", _SBX, [2, 2], [(0, 0), (1, 1)])
c("nn", "crelu", np.asarray([[-1.0, 2.0]], np.float32))
c("nn", "relu_layer", np.asarray([[-1.0, 2.0]], np.float32),
  np.eye(2, dtype=np.float32), np.asarray([0.5, -3.0], np.float32))
c("nn", "thresholded_relu", np.asarray([0.5, 1.5], np.float32), 1.0)
c("base", "histogram", np.asarray([0.0, 0.1, 0.9, 1.0, 0.5], np.float32), 2,
  range=(0.0, 1.0))
# r4b
_G3 = np.asarray([0.1, -0.2, 0.3], np.float32)
c("updater", "adam_updater", _G3, np.zeros(3, np.float32),
  np.zeros(3, np.float32), 1, 0.001, 0.9, 0.999, 1e-8)
_G2 = np.asarray([1.0, -2.0], np.float32)
c("updater", "sgd_updater", _G2, 0.5)
c("updater", "ada_grad_updater", _G2, np.zeros(2, np.float32), 0.01, 1e-6)
c("updater", "rms_prop_updater", _G2, np.zeros(2, np.float32), 0.001, 0.95)
c("updater", "momentum_updater", _G2, np.zeros(2, np.float32), 0.1, 0.9)
c("updater", "nesterovs_updater", _G2, np.zeros(2, np.float32), 0.1, 0.9)
_G43 = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)
_Z43 = np.zeros_like(_G43)
c("updater", "ada_delta_updater", _G43, _Z43, _Z43)
c("updater", "ada_max_updater", _G43, _Z43, _Z43, 1)
c("updater", "nadam_updater", _G43, _Z43, _Z43, 1)
c("updater", "ams_grad_updater", _G43, _Z43, _Z43, _Z43, 1)
c("signal", "stft", np.random.default_rng(2).standard_normal(512).astype(
    np.float32), 128, 64, window="hann", _atol=1e-4, _rtol=1e-4)
for _w in ("hann_window", "hamming_window", "blackman_window",
           "bartlett_window"):
    c("signal", _w, 64, periodic=False)
    c("signal", _w, 64, periodic=True)
c("signal", "kaiser_window", 32, 8.0)
c("signal", "linear_to_mel_weight_matrix", 20, 129, 8000, _atol=3e-5,
  _rtol=3e-5)
c("signal", "mfcc", np.random.default_rng(3).random((5, 20)).astype(
    np.float32), 13)
_RI = np.random.default_rng(4).random((8, 8, 3)).astype(np.float32)
for _k in (1, 2, 3):
    c("image", "rotate", _RI, _k * math.pi / 2, _atol=3e-5)
c("image", "translate", np.arange(25, dtype=np.float32).reshape(5, 5, 1),
  1.0, 2.0)
c("image", "affine_transform", np.random.default_rng(6).random(
    (6, 7, 2)).astype(np.float32), np.asarray(
    [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32))
c("base", "add_n", np.asarray([1.0, 2.0], np.float32),
  np.asarray([1.0, 2.0], np.float32), np.asarray([1.0, 2.0], np.float32))
c("base", "mirror_pad", np.asarray([[1.0, 2.0, 3.0]], np.float32),
  [(0, 0), (2, 2)], "REFLECT")
c("base", "mirror_pad", np.asarray([[1.0, 2.0, 3.0]], np.float32),
  [(0, 0), (1, 1)], "SYMMETRIC")
_NV = np.asarray([5.0, 1.0, 3.0, 2.0], np.float32)
c("base", "nth_element", _NV, 0)
c("base", "nth_element", _NV, 0, reverse=True)
c("base", "nth_element", _NV, 2)
c("base", "sufficient_statistics", np.random.default_rng(7).random(
    (3, 4)).astype(np.float32), (0,))
c("base", "mode", np.asarray([[1.0, 2.0, 2.0, 3.0], [4.0, 4.0, 5.0, 6.0]],
                             np.float32))
c("base", "sparse_to_dense", np.asarray([[0, 1], [2, 0]]), (3, 2),
  np.asarray([5.0, 6.0], np.float32), -1.0)
c("base", "unravel_index", np.asarray([5, 7]), (3, 4))
c("base", "ravel_multi_index", (np.asarray([1, 1]), np.asarray([1, 3])),
  (3, 4))
c("base", "put_along_axis", np.zeros((2, 3), np.float32),
  np.asarray([[0], [2]]), 9.0, 1)
_SA, _SBB = np.asarray([1, 2, 3, 4], np.int32), np.asarray([3, 4, 5],
                                                          np.int32)
c("base", "intersect1d", _SA, _SBB, size=4)
c("base", "union1d", _SA, _SBB, size=6)
c("base", "intersect1d", np.asarray([1.0, 2.0, 3.0], np.float32),
  np.asarray([3.0, 9.0], np.float32), size=3)
c("base", "bitcast", np.asarray([1.0], np.float32), "int32")
c("base", "hashcode", np.arange(6.0).astype(np.float32))
c("base", "hashcode", np.arange(6.0)[::-1].astype(np.float32))
c("base", "array_equal", np.zeros(3, np.float32), np.zeros(4, np.float32))
c("base", "array_equal", np.zeros((3, 1), np.float32),
  np.zeros((1, 3), np.float32))
c("math", "multigammaln", np.asarray([3.0, 4.5], np.float32), 2)
for _op in ("cot", "sec", "csc"):
    c("math", _op, np.float32(0.5))
c("math", "log1mexp", np.asarray([-1e-4, -0.5, -5.0], np.float32))
_R8 = np.random.default_rng(8)
c("linalg", "null_space", _R8.random((4, 6)).astype(np.float32),
  _atol=1e-4, _rtol=1e-4)
c("linalg", "orth", _R8.random((6, 3)).astype(np.float32), _atol=1e-4,
  _rtol=1e-4)
c("linalg", "log_matrix_determinant", np.asarray([[2.0, 0.0], [0.0, 3.0]],
                                                 np.float32))
c("linalg", "tensorinv", (_R8.random((2, 3, 2, 3))
                          + np.eye(6).reshape(2, 3, 2, 3)).astype(np.float32),
  2, _atol=1e-4, _rtol=1e-4)
_R9 = np.random.default_rng(9)
_BX = _R9.standard_normal((2, 5, 3)).astype(np.float32)
_BH = np.zeros((2, 4), np.float32)
_BW = [(_R9.standard_normal(s) * 0.1).astype(np.float32)
       for s in ((3, 16), (4, 16), (16,))] * 2
c("rnn", "bidirectional_lstm_layer", _BX, _BH, _BH, *_BW)
c("cnn", "atrous_conv2d", np.random.default_rng(10).random(
    (1, 8, 8, 2)).astype(np.float32), np.random.default_rng(11).random(
    (3, 3, 2, 4)).astype(np.float32), 2)
c("signal", "overlap_and_add", np.ones((4, 8), np.float32), 4)
c("signal", "frame", np.arange(10.0).astype(np.float32), 4, 2, pad_end=True)
c("signal", "frame", np.arange(12.0).astype(np.float32), 2, 4, pad_end=True)
c("image", "non_max_suppression_with_scores",
  np.asarray([[0, 0, 10, 10], [0, 0, 10.5, 10.5], [20, 20, 30, 30]],
             np.float32), np.asarray([0.9, 0.8, 0.7], np.float32), 3,
  iou_threshold=0.5)
_SIG = np.random.default_rng(0).standard_normal(1024).astype(np.float32)
c("signal", "spectrogram", _SIG, 256, 128, _atol=2e-4, _rtol=2e-4)
c("signal", "log_mel_spectrogram", _SIG, 256, 128, num_mel_bins=40,
  _atol=5e-4, _rtol=5e-4)
# r5
c("nn", "embedding_lookup", np.random.default_rng(0).normal(
    size=(10, 4)).astype(np.float32), np.asarray([3, 7, 3]))
c("nn", "embedding_lookup", np.random.default_rng(0).normal(
    size=(10, 4)).astype(np.float32) * 100.0, np.asarray([3, 7, 3]),
  max_norm=1.0)
c("nn", "xw_plus_b", np.ones((2, 3), np.float32),
  np.full((3, 4), 2.0, np.float32), np.asarray([1.0, 2.0, 3.0, 4.0],
                                               np.float32))
_CB = np.asarray([1.0, -1.0, 1.0, -1.0, -1.0, -1.0, -1.0, 1.0], np.float32)
c("base", "compare_and_bitpack", _CB, 0.0)
c("base", "compare_and_bitpack", np.stack([_CB, -_CB]), 0.0)
_RB = np.random.default_rng(1)
_GA = _RB.normal(size=(4, 3, 5)).astype(np.float32)
_GB = _RB.normal(size=(4, 5, 2)).astype(np.float32)
_GC = _RB.normal(size=(4, 3, 2)).astype(np.float32)
c("linalg", "batched_gemm", _GA, _GB, alpha=2.0, beta=0.5, c=_GC)
c("linalg", "batched_gemm", _GA.transpose(0, 2, 1).copy(), _GB,
  transpose_a=True)
c("base", "choose", np.asarray([1.0, 5.0, -2.0, 7.0], np.float32), 4, 3.0)
