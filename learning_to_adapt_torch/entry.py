"""The flagship model's forward step, as a function and its arguments
(`entry()` of the JAX package's __graft_entry__.py): the GrBAL meta-MLP
dynamics forward over the planner's rows, which on the card runs the
fused-MLP kernel (ops/fused_mlp.py).

    fn, example_args = entry()        # on the card
    next_obs = fn(*example_args)      # (2500, 20)
"""
import torch

from learning_to_adapt_torch.envs import HalfCheetahEnv, normalize
from learning_to_adapt_torch.models import MetaMLPDynamicsModel

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
