"""Action/observation spaces (learning_to_adapt_tpu/envs/spaces.py): Box,
Discrete, Product, rllab-style sample/flatten helpers, numpy only."""
import numpy as np


class Space:
    def sample(self, rng=None):
        raise NotImplementedError

    def contains(self, x):
        raise NotImplementedError

    @property
    def flat_dim(self):
        raise NotImplementedError

    def flatten(self, x):
        raise NotImplementedError

    def unflatten(self, x):
        raise NotImplementedError


class Box(Space):
    def __init__(self, low, high, shape=None):
        if shape is None:
            self.low = np.atleast_1d(np.asarray(low, np.float32))
            self.high = np.atleast_1d(np.asarray(high, np.float32))
        else:
            self.low = np.full(shape, low, np.float32)
            self.high = np.full(shape, high, np.float32)
        assert self.low.shape == self.high.shape

    @property
    def shape(self):
        return self.low.shape

    @property
    def bounds(self):
        return self.low, self.high

    @property
    def flat_dim(self):
        return int(np.prod(self.low.shape))

    def sample(self, rng=None):
        rng = rng or np.random
        return rng.uniform(self.low, self.high, self.low.shape).astype(
            np.float32)

    def contains(self, x):
        x = np.asarray(x)
        return (x.shape == self.shape and (x >= self.low).all() and
                (x <= self.high).all())

    def flatten(self, x):
        return np.asarray(x).flatten()

    def unflatten(self, x):
        return np.asarray(x).reshape(self.shape)

    def flatten_n(self, xs):
        return np.asarray(xs).reshape(len(xs), -1)

    def unflatten_n(self, xs):
        return np.asarray(xs).reshape((len(xs),) + self.shape)

    def __eq__(self, other):
        return (isinstance(other, Box) and
                np.allclose(self.low, other.low) and
                np.allclose(self.high, other.high))

    def __repr__(self):
        return f'Box{self.shape}'


class Discrete(Space):
    def __init__(self, n):
        self.n = n

    @property
    def shape(self):
        return (self.n,)

    @property
    def flat_dim(self):
        return self.n

    def sample(self, rng=None):
        rng = rng or np.random
        return rng.randint(self.n)

    def contains(self, x):
        return 0 <= int(x) < self.n

    def flatten(self, x):
        out = np.zeros(self.n, np.float32)
        out[int(x)] = 1.0
        return out

    def unflatten(self, x):
        return int(np.argmax(x))

    def __eq__(self, other):
        return isinstance(other, Discrete) and self.n == other.n

    def __repr__(self):
        return f'Discrete({self.n})'


class Product(Space):
    def __init__(self, *components):
        if len(components) == 1 and isinstance(components[0], (list, tuple)):
            components = tuple(components[0])
        self.components = components

    @property
    def flat_dim(self):
        return sum(c.flat_dim for c in self.components)

    def sample(self, rng=None):
        return tuple(c.sample(rng) for c in self.components)

    def contains(self, x):
        return (len(x) == len(self.components) and
                all(c.contains(xi) for c, xi in zip(self.components, x)))

    def flatten(self, x):
        return np.concatenate([c.flatten(xi)
                               for c, xi in zip(self.components, x)])

    def unflatten(self, x):
        out = []
        i = 0
        for c in self.components:
            out.append(c.unflatten(x[i:i + c.flat_dim]))
            i += c.flat_dim
        return tuple(out)

    def __eq__(self, other):
        return (isinstance(other, Product) and
                self.components == other.components)
