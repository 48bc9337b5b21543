"""Operations and bytes, counted from shapes.

fused MLP launch (ops/fused_mlp.py): G groups of R rows through widths
d_0 -> ... -> d_L: 2 R sum_l d_l d_{l+1} operations a group (bf16
products, f32 accumulation); bytes: the f32 input (R d_0) and output
(R d_L) of each group, each weight set's bf16 weights and f32 biases once
(one set when the groups share it), each read or written once.

Jacobi tier launch (ops/jacobi.py): E systems of N rows, S sweeps of
f <- max(f - w (A f + b) / a_ii, 0): 2 N^2 + 5 N operations a sweep and
system (f32); bytes: A, b, 1/a_ii and w read once, f written once. Rows
that carry no constraint are counted as the tier kernel sweeps them.

Model FLOPs, counting each product once and no recomputation: a forward
of R rows is F = 2 R P with P = sum_l d_l d_{l+1}; its backward 2F.
"""
import math

from . import peaks


def mlp_dims(hp):
    return [hp.obs_dim + hp.act_dim] + hp.hidden + [hp.obs_dim]


def mlp_products(dims):
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def fused_mlp_launch(groups, rows, dims, weight_sets):
    """(operations, bytes) of one launch: `groups` groups of `rows` rows,
    `weight_sets` distinct weight sets (1 when shared)."""
    p = mlp_products(dims)
    flops = 2 * groups * rows * p
    n_bytes = (groups * rows * (dims[0] + dims[-1]) * 4 +
               weight_sets * (2 * p + 4 * sum(dims[1:])))
    return flops, n_bytes


def jacobi_launch(systems, rows, sweeps):
    flops = systems * sweeps * (2 * rows * rows + 5 * rows)
    n_bytes = systems * (rows * rows + 2 * rows + 1 + rows) * 4
    return flops, n_bytes


def adapting(hp, t):
    """Whether GrBAL adapts at step t (after its window of adapt_batch_size
    transitions has filled: t > adapt_batch_size + 1)."""
    a_bs = hp.adapt_batch_size
    return hp.algo == 'grbal' and bool(a_bs) and t > a_bs + 1


def sampling_launches(hp):
    """The fused-MLP launches of one sampling call as
    [(count, groups, rows, weight sets)]: `horizon` a step; GrBAL runs one
    group an env (its own adapted set once adapting, the shared set
    before), MB-MPC one group of every env's candidates."""
    envs, t_len = hp.envs, hp.t_len
    h, n = hp.horizon, hp.n_candidates
    if hp.algo == 'grbal':
        adapted = sum(adapting(hp, t) for t in range(t_len))
        return [(h * adapted, envs, n, envs),
                (h * (t_len - adapted), envs, n, 1)]
    return [(h * t_len, 1, n * envs, 1)]


def sampling_min_s(hp):
    """Least device seconds of one sampling call's model FLOPs: the
    planner's forwards at the bf16 peak, GrBAL's adaptation (forward and
    backward of the adapt batch, every env, each adapting step) at the f32
    peak."""
    dims = mlp_dims(hp)
    planner = sum(c * fused_mlp_launch(g, r, dims, w)[0]
                  for c, g, r, w in sampling_launches(hp))
    adapt = 0
    if hp.algo == 'grbal':
        steps = sum(adapting(hp, t) for t in range(hp.t_len))
        rows = hp.envs * hp.adapt_batch_size
        adapt = steps * 3 * 2 * rows * mlp_products(dims)
    return planner / peaks.FLOPS['bf16'] + adapt / peaks.FLOPS['f32']


def fit_step_flops(hp):
    """Model FLOPs of one train step. GrBAL, on meta_batch_size tasks of
    batch_size rows before and after the inner step: the inner forward F
    and backward 2F, the post-update forward F' and backward 2F', and the
    second-order term, the backward through the inner gradient, 4F. MB-MPC:
    forward and backward of batch_size rows, 3F."""
    p = mlp_products(mlp_dims(hp))
    if hp.algo == 'grbal':
        f = 2 * hp.meta_batch_size * hp.batch_size * p
        return 7 * f + 3 * f
    return 3 * 2 * hp.batch_size * p


def bucket_pow2(n):
    """A step count rounded to the nearest power of two (>= 1): how the
    fits size an epoch."""
    if n <= 1:
        return 1
    return int(2 ** round(math.log2(n)))
