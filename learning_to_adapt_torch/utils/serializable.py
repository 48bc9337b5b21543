"""Constructor-args serialization protocol (utils/serializable.py, rllab's
Serializable).

`quick_init` captures constructor arguments, pickling re-invokes the
constructor, and `clone` rebuilds with overrides. Envs ride in `params.pkl`
snapshots this way; model and optimizer state are explicit state dicts
(utils/checkpoint.py).
"""
import inspect


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
        out = type(self)(*d['__args'], **d['__kwargs'])
        self.__dict__.update(out.__dict__)

    @classmethod
    def clone(cls, obj, **kwargs):
        assert isinstance(obj, Serializable)
        d = obj.__getstate__()
        new_kwargs = dict(d['__kwargs'])
        new_kwargs.update(kwargs)
        return type(obj)(*d['__args'], **new_kwargs)
