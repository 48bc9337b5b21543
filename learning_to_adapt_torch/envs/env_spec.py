"""Env specification container (learning_to_adapt_tpu/envs/env_spec.py):
an observation space and an action space."""


class EnvSpec:
    def __init__(self, observation_space, action_space):
        self._observation_space = observation_space
        self._action_space = action_space

    @property
    def observation_space(self):
        return self._observation_space

    @property
    def action_space(self):
        return self._action_space
