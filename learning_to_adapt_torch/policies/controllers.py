"""MPC controllers (policies/controllers.py): static planner config and the
dynamics model reference. The sampler's rollout calls `plan_fn` (or
`plan_fn_recurrent`) on the device; `get_action(s)` wrap the same planners
for host-driven use, with numpy in and out.
"""
import numpy as np
import torch

from learning_to_adapt_torch.models.optim import tree_leaves, tree_unflatten
from learning_to_adapt_torch.policies import planners
from learning_to_adapt_torch.policies.base import Policy


class MPCController(Policy):
    def __init__(self, name, env, dynamics_model, discount=1.0,
                 use_cem=False, n_candidates=1024, horizon=10,
                 num_cem_iters=8, percent_elites=0.1, alpha=0.1, seed=0):
        super().__init__(env)
        self.name = name
        self.dynamics_model = dynamics_model
        self.discount = discount
        self.use_cem = use_cem
        self.n_candidates = n_candidates
        self.horizon = horizon
        self.num_cem_iters = num_cem_iters
        self.percent_elites = percent_elites
        self.alpha = alpha
        self.seed = seed
        self._generator = None  # the host API's, made on first use
        self.act_dim = self.unwrapped_env.act_dim

    @property
    def vectorized(self):
        return True

    def _planner_kw(self):
        return dict(n_candidates=self.n_candidates, horizon=self.horizon,
                    act_dim=self.act_dim, discount=self.discount)

    def plan_fn(self, predict, obs, generator, candidates=None, normals=None):
        """First actions (m, act_dim) for observations obs (m, obs_dim);
        predict is a (obs_rows, act_rows) -> next_obs_rows function.
        candidates / normals: injected draws (policies/planners.py)."""
        if self.use_cem:
            actions, _ = planners.cem(
                predict, self.unwrapped_env.reward, obs, generator,
                num_cem_iters=self.num_cem_iters,
                percent_elites=self.percent_elites, alpha=self.alpha,
                normals=normals, **self._planner_kw())
        else:
            actions, _ = planners.random_shooting(
                predict, self.unwrapped_env.reward, obs, generator,
                candidates=candidates, **self._planner_kw())
        return actions

    def draw(self, generator, m, dtype, device):
        """The planner's random draws for m envs, in the order plan_fn would
        make them: (candidates, None) for random shooting, (None, normals)
        for CEM (policies/planners.py)."""
        n, ha = self.n_candidates, self.horizon * self.act_dim
        if self.use_cem:
            return None, planners.draw_normals(
                generator, self.num_cem_iters, n, m, ha, dtype, device)
        return planners.draw_candidates(generator, self.horizon, n * m,
                                        self.act_dim, dtype, device), None

    # ---- host API ---------------------------------------------------------
    def _host_generator(self):
        if self._generator is None:
            self._generator = torch.Generator(
                device=self.dynamics_model.device)
            self._generator.manual_seed(self.seed)
        return self._generator

    def _tensor(self, observations):
        model = self.dynamics_model
        return torch.as_tensor(np.asarray(observations), dtype=model.dtype,
                               device=model.device)

    def get_action(self, observation):
        actions, info = self.get_actions(np.atleast_2d(observation))
        return actions[0], info

    @torch.no_grad()
    def get_actions(self, observations):
        model = self.dynamics_model
        obs = self._tensor(observations)
        if getattr(model, 'adapted', False):
            adapted = model._adapted_params
            n_env = adapted['w'][0].shape[0]

            def predict(o_rows, a_rows):
                per = o_rows.shape[0] // n_env
                out = model.predict_adapted_fn(
                    adapted, model.normalizer,
                    o_rows.reshape(n_env, per, -1),
                    a_rows.reshape(n_env, per, -1))
                return out.reshape(o_rows.shape[0], -1)
        else:
            def predict(o_rows, a_rows):
                return model.predict_fn(model.params, model.normalizer,
                                        o_rows, a_rows)
        actions = self.plan_fn(predict, obs, self._host_generator())
        return actions.cpu().numpy(), {}

    def get_random_action(self, n):
        gen = self._host_generator()
        u = torch.rand((n, self.act_dim), generator=gen, device=gen.device)
        return (2.0 * u - 1.0).cpu().numpy()


class RNNMPCController(MPCController):
    """MPC over a recurrent model: the planner fans each env's hidden state
    out over its candidates and advances it by the chosen action;
    reset(dones) zeroes the hidden state of each done env."""

    def __init__(self, name, env, dynamics_model, discount=1.0, use_cem=False,
                 n_candidates=1024, horizon=10, num_cem_iters=8,
                 percent_elites=0.05, alpha=0.1, num_rollouts=1, seed=0):
        super().__init__(name, env, dynamics_model, discount=discount,
                         use_cem=use_cem, n_candidates=n_candidates,
                         horizon=horizon, num_cem_iters=num_cem_iters,
                         percent_elites=percent_elites, alpha=alpha,
                         seed=seed)
        self.num_rollouts = num_rollouts
        self._hidden = None

    @property
    def recurrent(self):
        return True

    def plan_fn_recurrent(self, predict_h, obs, hidden, generator,
                          candidates=None, normals=None):
        """(actions (m, act_dim), hidden after the chosen actions)."""
        if self.use_cem:
            return planners.cem_recurrent(
                predict_h, self.unwrapped_env.reward, obs, hidden, generator,
                num_cem_iters=self.num_cem_iters,
                percent_elites=self.percent_elites, normals=normals,
                **self._planner_kw())
        return planners.random_shooting_recurrent(
            predict_h, self.unwrapped_env.reward, obs, hidden, generator,
            candidates=candidates, **self._planner_kw())

    @torch.no_grad()
    def get_actions(self, observations):
        model = self.dynamics_model
        obs = self._tensor(observations)
        if self._hidden is None:
            self._hidden = model.get_initial_hidden(obs.shape[0])

        def predict_h(o, a, h):
            return model.predict_fn(model.params, model.normalizer, o, a, h)
        actions, self._hidden = self.plan_fn_recurrent(
            predict_h, obs, self._hidden, self._host_generator())
        return actions.cpu().numpy(), {}

    def reset(self, dones=None):
        model = self.dynamics_model
        if dones is None:
            self._hidden = None
            return
        n = len(dones)
        if self._hidden is None:
            self._hidden = model.get_initial_hidden(n)
            return
        mask = torch.as_tensor(np.asarray(dones, bool),
                               device=model.device)[:, None]
        zeros = tree_leaves(model.get_initial_hidden(n))
        self._hidden = tree_unflatten(self._hidden, [
            torch.where(mask, z, h)
            for h, z in zip(tree_leaves(self._hidden), zeros)])
