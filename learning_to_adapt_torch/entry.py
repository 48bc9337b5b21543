"""The JAX package's __graft_entry__.py: `entry()`, the flagship model's
forward step as a function and its arguments (the GrBAL meta-MLP dynamics
forward over the planner's rows, which on the card runs the fused-MLP
kernel, ops/fused_mlp.py), and `dryrun_multichip(n)`, one tiny GrBAL
training step sharded over n ranks.

    fn, example_args = entry()        # on the card
    next_obs = fn(*example_args)      # (2500, 20)
    dryrun_multichip(2, device='cpu') # 2 ranks over gloo
"""
import numpy as np
import torch

from learning_to_adapt_torch.envs import HalfCheetahEnv, normalize
from learning_to_adapt_torch.models import MetaMLPDynamicsModel
from learning_to_adapt_torch.models.optim import ClipAdam
from learning_to_adapt_torch.parallel import mesh as par_mesh
from learning_to_adapt_torch.policies import MPCController
from learning_to_adapt_torch.samplers.rollout import make_rollout_fn

#: the canonical GrBAL planner's rows: 5 envs x 500 candidates
BATCH = 2500


def entry(device='cuda'):
    """(fn, example_args): fn(params, normalizer, obs, act) -> next obs
    (BATCH, obs_dim) through the HalfCheetah GrBAL meta-MLP (512, 512, 512)
    built on `device`; the observations and actions are drawn from a
    torch.Generator seeded with 0."""
    env = normalize(HalfCheetahEnv(task=None, device=device))
    model = MetaMLPDynamicsModel('dyn', env, hidden_sizes=(512, 512, 512),
                                 batch_size=16, device=device)

    def fn(params, norm, obs, act):
        return model.predict_fn(params, norm, obs, act)

    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    obs = torch.randn((BATCH, env.obs_dim), generator=gen,
                      device=model.device)
    act = 2.0 * torch.rand((BATCH, env.act_dim), generator=gen,
                           device=model.device) - 1.0
    return fn, (model.params, model.normalizer, obs, act)


def dryrun_multichip(n_devices, device='cuda'):
    """Runs one GrBAL-style training step on n_devices ranks (processes
    started by spawn, parallel/mesh.py spawn) at tiny shapes, each rank on
    `device` ('cuda': its own card over nccl; 'cpu': gloo): a rollout
    sharded over the env axis (2 envs a rank, 8 steps, adaptation on the
    last 4), the meta fit sharded over the ranks for 2 epochs, and a
    data_parallel_grad_step of the second-order meta loss. Raises if a rank
    fails or a loss is not finite. The JAX dryrun also lowers and compiles
    the canonical-shape programs without running them; nothing is compiled
    ahead here, so that part has no counterpart."""
    par_mesh.spawn(_dryrun_rank, n_devices, args=(device,))


def _dryrun_rank(device):
    mesh = par_mesh.make_mesh(device=device)
    try:
        dev = mesh.device
        env = normalize(HalfCheetahEnv(task='cripple',
                                       reset_every_episode=True, device=dev))
        model = MetaMLPDynamicsModel('dyn', env, hidden_sizes=(32, 32),
                                     meta_batch_size=2, batch_size=4,
                                     inner_learning_rate=0.01, device=dev)
        policy = MPCController('policy', env, model, n_candidates=4,
                               horizon=2)
        num_rollouts, t_len = 2 * mesh.shape['env'], 8
        rollout = make_rollout_fn(env, policy, model, num_rollouts, t_len,
                                  adapt_batch_size=4, mesh=mesh)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        paths = par_mesh.gather(mesh, rollout(model.params, model.normalizer,
                                              gen, 1))
        obs, act, nxt = (paths[k] for k in ('observations', 'actions',
                                            'next_observations'))
        model.mesh = mesh
        stats = model.fit(obs, act, nxt, epochs=2)
        if not np.isfinite(stats['post_loss']):
            raise FloatingPointError('sharded meta fit: non-finite loss')

        def loss_fn(params, obs, act, delta):
            # each 8-step path is one task: adapt on its first 4 steps,
            # score the last 4
            return model.meta_loss_fn(params, model.normalizer, obs, act,
                                      delta)[0]
        optimizer = ClipAdam(1e-3)
        step = par_mesh.data_parallel_grad_step(mesh, loss_fn, optimizer)
        batch = par_mesh.shard_batch(mesh, (obs, act, nxt - obs))
        _, _, loss = step(model.params, optimizer.init(model.params), *batch)
        if not torch.isfinite(loss):
            raise FloatingPointError('data-parallel step: non-finite loss')
    finally:
        mesh.close()
