"""Return / advantage (GAE) sample processor (samplers/gae_processor.py of
the JAX package): discounted returns, GAE advantages against a fitted
linear baseline, and return statistics. The three model-based entry points
use ModelSampleProcessor; this is the policy-gradient surface of the
framework, on the host in numpy.
"""
import numpy as np

from learning_to_adapt_torch.utils import logging as logger
from learning_to_adapt_torch.utils.tensor_utils import (
    discount_cumsum, normalize_advantages)


class LinearFeatureBaseline:
    """rllab-style linear baseline on polynomial obs/time features."""

    def __init__(self, reg_coeff=1e-5):
        self._coeffs = None
        self._reg_coeff = reg_coeff

    def _features(self, path):
        obs = np.clip(path['observations'], -10, 10)
        t = path['t'] if 't' in path else \
            np.arange(len(obs)).reshape(-1, 1) / 100.0
        return np.concatenate(
            [obs, obs ** 2, t, t ** 2, t ** 3, np.ones((len(obs), 1))],
            axis=1)

    def fit(self, paths):
        feats = np.concatenate([self._features(p) for p in paths])
        returns = np.concatenate([p['returns'] for p in paths])
        reg = self._reg_coeff
        for _ in range(5):
            try:
                self._coeffs = np.linalg.lstsq(
                    feats.T @ feats + reg * np.eye(feats.shape[1]),
                    feats.T @ returns, rcond=None)[0]
                break
            except np.linalg.LinAlgError:
                reg *= 10
        return self

    def predict(self, path):
        if self._coeffs is None:
            return np.zeros(len(path['observations']))
        return self._features(path) @ self._coeffs


class SampleProcessor:
    def __init__(self, baseline=None, discount=0.99, gae_lambda=1.0,
                 normalize_adv=True, positive_adv=False):
        self.baseline = baseline or LinearFeatureBaseline()
        self.discount = discount
        self.gae_lambda = gae_lambda
        self.normalize_adv = normalize_adv
        self.positive_adv = positive_adv

    def process_samples(self, paths, log=False, log_prefix=''):
        """paths: the Sampler's dict of [n_paths, T, ...] arrays, or a list
        of per-path dicts (which gain 'returns' and 'advantages')."""
        if isinstance(paths, dict):
            paths = [
                dict(observations=paths['observations'][i],
                     actions=paths['actions'][i],
                     rewards=paths['rewards'][i])
                for i in range(paths['observations'].shape[0])]

        for path in paths:
            path['returns'] = discount_cumsum(path['rewards'], self.discount)
        self.baseline.fit(paths)

        for path in paths:
            baselines = np.append(self.baseline.predict(path), 0.0)
            deltas = (path['rewards'] + self.discount * baselines[1:] -
                      baselines[:-1])
            path['advantages'] = discount_cumsum(
                deltas, self.discount * self.gae_lambda)

        observations = np.concatenate([p['observations'] for p in paths])
        actions = np.concatenate([p['actions'] for p in paths])
        rewards = np.concatenate([p['rewards'] for p in paths])
        returns = np.concatenate([p['returns'] for p in paths])
        advantages = np.concatenate([p['advantages'] for p in paths])
        if self.normalize_adv:
            advantages = normalize_advantages(advantages)
        if self.positive_adv:
            advantages = advantages - advantages.min() + 1e-8

        undisc = [p['rewards'].sum() for p in paths]
        if log:
            logger.logkv(log_prefix + 'AverageReturn', np.mean(undisc))
            logger.logkv(log_prefix + 'MaxReturn', np.max(undisc))
            logger.logkv(log_prefix + 'MinReturn', np.min(undisc))
            logger.logkv(log_prefix + 'StdReturn', np.std(undisc))
            logger.logkv(log_prefix + 'NumTrajs', len(paths))

        return dict(observations=observations, actions=actions,
                    rewards=rewards, returns=returns, advantages=advantages)
