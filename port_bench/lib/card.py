"""The card a run stands on, and what a run may not have loaded."""
import sys

import torch

#: top-level module names (compared whole) that a run of the port must
#: not have loaded: the JAX package and JAX itself
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'learning_to_adapt_tpu')


class NoCard(RuntimeError):
    pass


def require_cards(n):
    """Raises NoCard unless torch sees n CUDA cards or more."""
    if not torch.cuda.is_available():
        raise NoCard('torch.cuda.is_available() is False: the benchmark '
                     'measures the port on a card and prints no result '
                     'without one')
    if torch.cuda.device_count() < n:
        raise NoCard(f'the cell asks for {n} cards, torch sees '
                     f'{torch.cuda.device_count()}')


def forbidden_modules(modules=None):
    """The loaded modules whose top-level name is a forbidden one."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules)
                  if m.split('.')[0] in FORBIDDEN)


def device_record(count, device):
    """The result line's `device`: the card's name, the cards used and the
    peak of allocated memory on the fullest one."""
    return dict(platform='gpu', kind=torch.cuda.get_device_name(device),
                count=count,
                memory_peak_bytes=int(max(torch.cuda.max_memory_allocated(d)
                                          for d in range(count))))
