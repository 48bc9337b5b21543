"""Constructor-args serialization protocol (utils/serializable.py, rllab's
Serializable).

`quick_init` captures constructor arguments, pickling re-invokes the
constructor, and `clone` rebuilds with overrides. Envs ride in `params.pkl`
snapshots this way; model and optimizer state are explicit state dicts
(utils/checkpoint.py). Inside `device_override(device)`, unpickling replays
every constructor that records a `device` with that device instead, so a
snapshot written on the card loads on a machine without one.
"""
import contextlib
import contextvars
import inspect

_DEVICE = contextvars.ContextVar('serializable_device', default=None)


@contextlib.contextmanager
def device_override(device):
    """Within the block, objects unpickled here are built on `device`
    (None keeps the recorded one)."""
    token = _DEVICE.set(device)
    try:
        yield
    finally:
        _DEVICE.reset(token)


class Serializable:
    def __init__(self, *args, **kwargs):
        self.__args = args
        self.__kwargs = kwargs

    def quick_init(self, locals_):
        if getattr(self, '_serializable_initialized', False):
            return
        sig = inspect.signature(self.__init__)
        positional = []
        kwargs = {}
        for name, param in sig.parameters.items():
            if name == 'self':
                continue
            if param.kind == inspect.Parameter.VAR_KEYWORD:
                kwargs.update(locals_.get(name, {}))
            elif param.kind == inspect.Parameter.VAR_POSITIONAL:
                positional.extend(locals_.get(name, ()))
            elif name in locals_:
                kwargs[name] = locals_[name]
        self.__args = tuple(positional)
        self.__kwargs = kwargs
        self._serializable_initialized = True

    def __getstate__(self):
        return {'__args': self.__args, '__kwargs': self.__kwargs}

    def __setstate__(self, d):
        kwargs = d['__kwargs']
        device = _DEVICE.get()
        if device is not None and 'device' in kwargs:
            kwargs = dict(kwargs, device=device)
        out = type(self)(*d['__args'], **kwargs)
        self.__dict__.update(out.__dict__)

    @classmethod
    def clone(cls, obj, **kwargs):
        assert isinstance(obj, Serializable)
        d = obj.__getstate__()
        new_kwargs = dict(d['__kwargs'])
        new_kwargs.update(kwargs)
        return type(obj)(*d['__args'], **new_kwargs)
