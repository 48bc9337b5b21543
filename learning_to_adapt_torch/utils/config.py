"""Config helpers (utils/config.py): the resume guard, the task-distribution
flags, and ClassEncoder, which dumps classes/callables by name so
params.json stays readable and viskit-style grouping works."""
import json
import os

#: config keys that define the training task distribution / run identity —
#: a resumed run silently continuing with different values for any of
#: these would contaminate the experiment (e.g. forgetting --cripple_set
#: on --resume would train on the held-out actuator and clobber the
#: recorded config)
RESUME_IDENTITY_KEYS = ('env', 'task', 'cripple_set', 'terrain_set',
                        'damping_range', 'force_range', 'seed')

#: config keys that parameterize the training task distribution, with
#: their CLI parsers — one source of truth for the entry point's flags, the
#: env constructor kwargs and RESUME_IDENTITY_KEYS above
TASK_DISTRIBUTION_KEYS = {
    'cripple_set': (
        lambda s: tuple(int(x) for x in s.split(',')),
        'comma-separated leg/actuator ids the cripple task distribution '
        'draws from (meta-test holdout protocol), e.g. "1,2,3,5"'),
    'terrain_set': (
        lambda s: tuple(s.split(',')),
        'comma-separated named terrain variants the hfield task '
        'distribution draws from (continuous-OOD holdout protocol), '
        'e.g. "gentle,hill"'),
    'damping_range': (
        lambda s: tuple(float(x) for x in s.split(':')),
        'lo:hi uniform block-damping range for the blocks damping task '
        '(default 0:10, the reference range)'),
    'force_range': (
        lambda s: tuple(float(x) for x in s.split(':')),
        'lo:hi uniform object-force scale range for the arm force task '
        '(default 0.1:2, the reference range)'),
}


def add_task_distribution_args(parser):
    """Register the task-distribution CLI flags on an argparse parser."""
    for key, (_, help_text) in TASK_DISTRIBUTION_KEYS.items():
        parser.add_argument(f'--{key}', type=str, default=None,
                            help=help_text)


def apply_task_distribution_args(args, config):
    """Parse any task-distribution flags present on args into config."""
    for key, (parse, _) in TASK_DISTRIBUTION_KEYS.items():
        val = getattr(args, key, None)
        if val:
            config[key] = parse(val)


def task_env_kwargs(config):
    """Env ctor kwargs for the task-distribution keys set in config."""
    return {k: tuple(config[k]) for k in TASK_DISTRIBUTION_KEYS
            if config.get(k)}


def _norm_cfg_value(key, v):
    if key == 'env':
        if isinstance(v, dict):
            v = v.get('$class', '')
        if isinstance(v, type):
            v = v.__module__ + '.' + v.__name__
        return str(v).split('.')[-1]
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return v


def check_resume_config(exp_dir, config, keys=RESUME_IDENTITY_KEYS):
    """Guard --resume against a mismatched CLI config: compare the saved
    exp_dir/params.json against the rebuilt config on the task-identity
    keys and raise before anything is overwritten."""
    path = os.path.join(exp_dir, 'params.json')
    if not os.path.exists(path):
        return
    with open(path) as f:
        saved = json.load(f)
    for k in keys:
        old = _norm_cfg_value(k, saved.get(k))
        new = _norm_cfg_value(k, config.get(k))
        if old != new:
            raise ValueError(
                f"--resume config mismatch for '{k}': the snapshot in "
                f'{exp_dir} was trained with {old!r} but the command line '
                f'rebuilds {new!r}. Pass the original flags (or a new '
                f'--exp_name) — resuming would silently continue training '
                f'on a different task distribution and overwrite the '
                f'recorded config.')


class ClassEncoder(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, type):
            return {'$class': o.__module__ + '.' + o.__name__}
        if callable(o):
            return {'$function': getattr(o, '__module__', '?') + '.' +
                    getattr(o, '__name__', repr(o))}
        try:
            return json.JSONEncoder.default(self, o)
        except TypeError:
            return repr(o)
