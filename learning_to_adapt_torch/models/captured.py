"""The fits' compiled epoch: a model's train step and validation step, each
captured once as a CUDA graph and replayed (models/captured.py).

The JAX package compiles a fit's whole epoch, two lax.scans of train and
validation steps, with jax.jit and caches it by shape in `_epoch_cache`
(MetaMLPDynamicsModel._get_epoch_fn, MLPDynamicsModel._get_epoch_fn and
RNNDynamicsModel._get_epoch_fn; parallel/mesh.py jit_epoch_sharded under a
mesh). This module is the port's stand-in for that jit and has no JAX
module of the same name.

Each model keeps one train step and one validation step, functions of a
fit state (`new_state`) that they update in place: the parameters that
autograd differentiates (requires_grad set once), Adam's count and
moments, the staged data, the normalizer, the epoch's index table, a
device step counter and the loss sums. Two callers run those steps:

  fit        (models/fitting.py) CompiledEpoch holds a state of static
             buffers for one shape key and runs each step through a
             StepGraph; the fit copies its parameters, optimizer state,
             normalizer and data in when it starts and copies fresh
             parameter tensors out when it ends, so nothing a caller holds
             aliases the buffers that the next fit overwrites;
  epoch_fn   the functional epoch the tests hold against the JAX
             package's: a state for one epoch around the tensors it is
             given, the steps called from Python.

The rule (`captures`), which StepGraph alone applies: a step is captured
as a CUDA graph and replayed on a CUDA device, without a mesh or with a
mesh over nccl; on the CPU and on a gloo mesh, whose collectives cannot be
captured, it is called as a function. So a fit takes one path everywhere.
Nothing falls back: a capture that fails raises from the fit.

A step reads its random draws from the state's index table at the step
counter, which it advances: the epoch's window indices, permutation or
path indices are drawn eagerly, once an epoch, from the fit's generator
and copied into the table, so no host int enters a graph and the
generator needs no registration with one.

Before its capture a step runs WARMUP times on a side stream, which sets
up cuBLAS's and cuDNN's workspaces, autograd's lazy state and an NCCL
communicator as the PyTorch CUDA-graph notes require; the warm-ups change
the state, so the fit loads it after capturing. The collective counters
of parallel/mesh.py and the kernel counters of ops/ (`kernel_counts`)
count a captured step's collectives and launches once a replay; the
warm-ups' and the capture's are kept out of them, in the StepGraph.

samplers/rollout.py's CompiledRollout captures a sampling step with the
same StepGraph. Its step draws from a generator: the StepGraph registers
that generator with the graph, so each replay takes the draws the eager
step would take from the generator's state and advances it as far, and
it leaves the generator where it found it after the warm-ups and the
capture. Its graphs share one memory pool, as they replay one after the
other.

Spans (utils/tracing.py): a host span around each replay ('fit.train_step',
'fit.valid_step', 'rollout.step'); with tracing on, a StepGraph captures
its step's device stamps (the step's begin and end, and the spans inside
it: 'fit.loss', 'fit.grad', 'fit.optim', the recurrent model's 'rnn.seq';
'rollout.plan', 'rollout.adapt', 'rollout.env_step', the engine's
'physics.qacc' and 'physics.smooth'), which fire at every replay. The
graphs are kept by the tracing state at their capture, so stamped copies
stand beside the graphs captured with tracing off and leave them as they
were. Every capture
counts 'graph.captures' and 'graph.capture_s'; every replay of a step that
launches the fused MLP counts its launches on the warpgroup-MMA kernel in
'fused_mlp.wgmma_launches' (0 where none), and every replay of a step that
runs the physics its dynamics passes in 'physics.passes', as an eager
launch and an eager pass do.
"""
import gc
import time
from types import SimpleNamespace

import torch

from learning_to_adapt_torch.models.optim import tree_leaves, tree_map
from learning_to_adapt_torch.ops import (
    clip_adam, fused_mlp, jacobi, smooth_dynamics)
from learning_to_adapt_torch.parallel import mesh as par_mesh
from learning_to_adapt_torch.physics import engine
from learning_to_adapt_torch.utils import tracing

WARMUP = 3  # step calls on a side stream before a capture


def captures(device, mesh):
    """True where a step is captured as a CUDA graph: a CUDA device, with
    no mesh or a mesh over nccl. On the CPU and over gloo it is called."""
    return torch.device(device).type == 'cuda' and (
        mesh is None or mesh.backend == 'nccl')


def new_state(leaves, count, mu, nu, n_sums, **fields):
    """A fit state: `leaves` are the step's parameter tensors (each with
    storage of its own, or a view the model laid out), marked
    requires_grad here; count, mu and nu are copies of Adam's state in the
    leaves' layout; a step counter (int64, (1,)) and n_sums loss sums
    (f32) start at 0; `fields` are the model's (data, normalizer, index
    tables, ...)."""
    for p in leaves:
        p.requires_grad_(True)
    dev = leaves[0].device
    return SimpleNamespace(
        leaves=leaves, count=count.detach().clone(),
        mu=[m.detach().clone(memory_format=torch.contiguous_format)
            for m in mu],
        nu=[v.detach().clone(memory_format=torch.contiguous_format)
            for v in nu],
        counter=torch.zeros(1, dtype=torch.int64, device=dev),
        sums=torch.zeros(n_sums, dtype=leaves[0].dtype, device=dev),
        **fields)


def clone_normalizer(norm):
    return type(norm)(**{k: v.clone() for k, v in vars(norm).items()})


@torch.no_grad()
def load(st, to_step, params, opt_state, norm, train, test):
    """Copies params and opt_state (trees, laid out for the state by
    to_step: a tree's leaves in the state's order and layout), the
    normalizer and the staged data into the state."""
    dst = st.leaves + st.mu + st.nu + [st.count] + list(vars(
        st.norm).values()) + tree_leaves((st.train, st.test))
    src = (to_step(params) + to_step(opt_state['mu']) +
           to_step(opt_state['nu']) + [opt_state['count']] +
           list(vars(norm).values()) + tree_leaves((train, test)))
    for d, s in zip(dst, src, strict=True):
        d.copy_(s)


def state_out(st, from_step, clone):
    """(params, opt_state) trees of a state (from_step: a leaf list in the
    state's order back to a tree of views): contiguous copies where clone
    (the state lives on), else detached views where they are contiguous
    (the state is dropped)."""
    def out(leaves):
        return tree_map(
            lambda x: x.clone(memory_format=torch.contiguous_format)
            if clone or not x.is_contiguous() else x,
            from_step([x.detach() for x in leaves]))
    return out(st.leaves), dict(
        count=st.count.clone() if clone else st.count, mu=out(st.mu),
        nu=out(st.nu))


@torch.no_grad()
def set_table(table, rows):
    """Writes an epoch's draws into the first rows of an index table."""
    table[:rows.shape[0]].copy_(rows)


@torch.no_grad()
def run_epoch(st, steps, steps_valid, train_step, valid_step):
    """steps train steps, then steps_valid validation steps, from step
    counter 0 and loss sums 0; each call is the span 'fit.train_step' or
    'fit.valid_step' (a replay's host side; the spans inside a captured
    step are its device stamps). Nothing here waits for the device."""
    st.counter.zero_()
    st.sums.zero_()
    for _ in range(steps):
        with tracing.span('fit.train_step'):
            train_step()
    for _ in range(steps_valid):
        with tracing.span('fit.valid_step'):
            valid_step()


def kernel_counts():
    """The kernel counters of ops/: fused-MLP launches (and those of them on
    the warpgroup-MMA kernel), weight packs, both Jacobi kernels' launches,
    the clip-and-Adam kernel's and the smooth-dynamics kernel's."""
    return dict(fused_mlp=fused_mlp.fused_mlp_forward.launches,
                fused_mlp_wgmma=fused_mlp.fused_mlp_forward.wgmma_launches,
                pack=fused_mlp.pack_weights.calls,
                jacobi_solve=jacobi.jacobi_solve.launches,
                jacobi_solve_cluster=jacobi.jacobi_solve_cluster.launches,
                clip_adam=clip_adam.clip_adam_.launches,
                smooth_dynamics=smooth_dynamics.smooth_dynamics.launches)


def count_kernels(counts):
    """Adds counts (as kernel_counts() gives them) to the kernel counters:
    a captured step's launches at each replay."""
    fused_mlp.fused_mlp_forward.launches += counts['fused_mlp']
    fused_mlp.fused_mlp_forward.wgmma_launches += counts['fused_mlp_wgmma']
    fused_mlp.pack_weights.calls += counts['pack']
    jacobi.jacobi_solve.launches += counts['jacobi_solve']
    jacobi.jacobi_solve_cluster.launches += counts['jacobi_solve_cluster']
    clip_adam.clip_adam_.launches += counts['clip_adam']
    smooth_dynamics.smooth_dynamics.launches += counts['smooth_dynamics']


def _counts():
    return par_mesh.collective_counts(), kernel_counts()


def _diff(after, before):
    return {k: after[k] - before[k] for k in after}


class StepGraph:
    """fn() captured once as a CUDA graph (`capture`) and replayed by each
    call; `replays` counts the calls. `generator`, when given, is the one
    fn draws from (registered with the graph); `pool`, a memory pool the
    graph shares with others that replay one after the other; `name`, the
    step's span; `mesh`, the one fn's collectives run on. Captured with
    tracing on, the graph holds the step's device stamps (`stamps`, their
    slots), read with the call's. Where `captures` does not hold (the CPU,
    a gloo mesh) a call runs fn and nothing is captured."""

    def __init__(self, fn, device, generator=None, pool=None, name='step',
                 mesh=None):
        self.fn = fn
        self.device = torch.device(device)
        # the device's type first: the tests patch `captures` to build the
        # compiled rollout on the CPU, where no graph can be made
        self.capturing = (self.device.type == 'cuda' and
                          captures(self.device, mesh))
        self.generator = generator
        self.pool = pool
        self.name = name
        self.graph = None
        self.stamps = ()
        self.replays = 0
        self.capture_s = 0.0
        self.collectives = self.warmup_collectives = None
        self.kernels = self.warmup_kernels = None
        self.passes = 0

    @torch.no_grad()
    def capture(self, reset):
        """WARMUP calls on a side stream, then one call under capture;
        reset() runs before each (outside the graph). The generator's
        state is put back as it was before the warm-ups. Raises if the
        capture fails."""
        t0 = time.perf_counter()
        if tracing.enabled():
            tracing.prepare(self.device)
        rng = None if self.generator is None else self.generator.get_state()
        before = _counts()
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side), tracing.quiet():
            for _ in range(WARMUP):
                reset()
                self.fn()
        stream.wait_stream(side)
        reset()
        warm = _counts()
        passes = engine._qacc.passes
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        # a graph destroyed during a capture (by a collection of the cycle
        # that held it) invalidates the capture: collect before, not during
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                with tracing.stamps(self.name, self.device) as stamped:
                    self.fn()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(self.device)
        after = _counts()
        self.passes = engine._qacc.passes - passes
        if rng is not None:
            self.generator.set_state(rng)
        (self.warmup_collectives, self.warmup_kernels) = (
            _diff(w, b) for w, b in zip(warm, before))
        self.collectives, self.kernels = (
            _diff(a, w) for a, w in zip(after, warm))
        par_mesh.count_collectives(
            {k: -n for k, n in _diff(after[0], before[0]).items()})
        count_kernels({k: -n for k, n in _diff(after[1], before[1]).items()})
        self.graph = graph
        self.stamps = stamped.slots
        self.capture_s = time.perf_counter() - t0
        tracing.count('graph.captures')
        tracing.count('graph.capture_s', self.capture_s)

    def __call__(self):
        if not self.capturing:
            self.fn()
            return
        self.graph.replay()
        self.replays += 1
        if self.stamps:
            tracing.replayed(self.device, self.stamps)
        par_mesh.count_collectives(self.collectives)
        count_kernels(self.kernels)
        if self.kernels['fused_mlp']:
            tracing.count('fused_mlp.wgmma_launches',
                          self.kernels['fused_mlp_wgmma'])
        if self.passes:
            tracing.count('physics.passes', self.passes)


class CompiledEpoch:
    """One shape key's static fit state and its two steps (StepGraphs on
    `mesh`), captured on the first `prepare` under each tracing state
    where `captures` holds (`graphs`: tracing on at the capture -> (train,
    valid) StepGraphs on the one state; `train` and `valid` are those of
    the tracing state now), which loads the state (load(st)) before and,
    on a capture, again after it. The warm-ups and the capture read the
    index tables (the state's int64 tensors but its counter) as the state
    was made, where every row indexes the train and the test data alike;
    after an epoch a row holds draws for one of them."""

    def __init__(self, state, train_step, valid_step, device, mesh=None):
        self.state = state
        self.steps = train_step, valid_step
        self.device = torch.device(device)
        self.mesh = mesh
        self.graphs = {}
        self.tables = [(v, v.clone()) for v in vars(state).values()
                       if torch.is_tensor(v) and v.dtype == torch.int64
                       and v is not state.counter]

    def _pair(self):
        on = tracing.enabled()
        if on not in self.graphs:
            train_step, valid_step = self.steps
            self.graphs[on] = (
                StepGraph(lambda: train_step(self.state), self.device,
                          name='fit.train_step', mesh=self.mesh),
                StepGraph(lambda: valid_step(self.state), self.device,
                          name='fit.valid_step', mesh=self.mesh))
        return self.graphs[on]

    @property
    def train(self):
        return self._pair()[0]

    @property
    def valid(self):
        return self._pair()[1]

    @property
    def captured(self):
        return self.train.graph is not None

    @property
    def capture_s(self):
        return sum(g.capture_s for pair in self.graphs.values()
                   for g in pair)

    def prepare(self, load):
        """load(state), capturing both steps first where they are to be
        captured and are not yet."""
        load(self.state)
        if self.captured or not self.train.capturing:
            return

        def reset():
            self.state.counter.zero_()
            for table, made in self.tables:
                table.copy_(made)
        self.train.capture(reset)
        self.valid.capture(reset)
        load(self.state)
