"""Checkpoint / resume helpers (utils/checkpoint.py).

Snapshots are plain pickles of state dicts of numpy arrays (params,
optimizer state, normalizer, dataset buffers); the env rides along by
constructor replay (utils/serializable.py), built on the device the loader
names, so a snapshot written on the card loads on any machine. The
sampler's generator state stays tied to its device type
(samplers/sampler.py).
"""
import os
import pickle

from learning_to_adapt_torch.utils.serializable import device_override


def save_snapshot(path, itr, dynamics_model, config=None, extra=None):
    snap = dict(itr=itr, dynamics_model=dynamics_model.state_dict(),
                config=config)
    if extra:
        snap.update(extra)
    with open(path, 'wb') as f:
        pickle.dump(snap, f)


def load_snapshot(path, device=None):
    """The snapshot at path; envs in it are built on `device` (None: the
    device each recorded)."""
    with open(path, 'rb') as f, device_override(device):
        return pickle.load(f)


def resume_trainer(exp_dir, dynamics_model, sampler=None, device=None):
    """Restores model state (params/opt/normalizer AND the aggregated
    dataset + split RNG) plus the sampler's generator/episode stream from an
    experiment dir; returns the next iteration index (0 without a snapshot).
    The snapshot's env is re-created on `device` (default: the model's).
    A resumed run is resume-equivalent: train(N) == train(k) + resume(N-k)
    up to f32 reduction order (tests/test_torch_train.py)."""
    path = os.path.join(exp_dir, 'params.pkl')
    if not os.path.exists(path):
        return 0
    snap = load_snapshot(path, device if device is not None
                         else dynamics_model.device)
    dynamics_model.load_state_dict(snap['dynamics_model'])
    if sampler is not None and snap.get('sampler') is not None:
        sampler.load_state_dict(snap['sampler'])
    return snap['itr'] + 1
