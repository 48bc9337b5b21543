"""Abstract policy interface (policies/base.py): get_action, get_actions,
reset, vectorized, recurrent, log_diagnostics."""


class Policy:
    def __init__(self, env=None):
        self.env = env
        self.unwrapped_env = env
        while hasattr(self.unwrapped_env, 'wrapped_env'):
            self.unwrapped_env = self.unwrapped_env.wrapped_env

    def get_action(self, observation):
        raise NotImplementedError

    def get_actions(self, observations):
        raise NotImplementedError

    def reset(self, dones=None):
        pass

    @property
    def vectorized(self):
        return False

    @property
    def recurrent(self):
        return False

    def log_diagnostics(self, paths):
        pass

    def get_params_internal(self, **tags):
        return []
