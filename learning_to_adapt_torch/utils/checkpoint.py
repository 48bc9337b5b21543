"""Checkpoint / resume helpers (utils/checkpoint.py).

Snapshots are plain pickles of state dicts of numpy arrays (params,
optimizer state, normalizer, dataset buffers), so a snapshot written on the
card loads on any machine; the env rides along by constructor replay
(utils/serializable.py).
"""
import os
import pickle


def save_snapshot(path, itr, dynamics_model, config=None, extra=None):
    snap = dict(itr=itr, dynamics_model=dynamics_model.state_dict(),
                config=config)
    if extra:
        snap.update(extra)
    with open(path, 'wb') as f:
        pickle.dump(snap, f)


def load_snapshot(path):
    with open(path, 'rb') as f:
        return pickle.load(f)


def resume_trainer(exp_dir, dynamics_model, sampler=None):
    """Restores model state (params/opt/normalizer AND the aggregated
    dataset + split RNG) plus the sampler's generator/episode stream from an
    experiment dir; returns the next iteration index (0 without a snapshot).
    A resumed run is resume-equivalent: train(N) == train(k) + resume(N-k)
    up to f32 reduction order (tests/test_torch_train.py)."""
    path = os.path.join(exp_dir, 'params.pkl')
    if not os.path.exists(path):
        return 0
    snap = load_snapshot(path)
    dynamics_model.load_state_dict(snap['dynamics_model'])
    if sampler is not None and snap.get('sampler') is not None:
        sampler.load_state_dict(snap['sampler'])
    return snap['itr'] + 1
