"""Environments: HalfCheetah (nominal or crippled, on terrain, on blocks),
the Ant and the 7-DoF arm."""
from learning_to_adapt_torch.envs.ant import AntEnv  # noqa: F401
from learning_to_adapt_torch.envs.arm import Arm7DofEnv  # noqa: F401
from learning_to_adapt_torch.envs.base import (  # noqa: F401
    EnvState, NormalizedEnv, TorchEnv, normalize)
from learning_to_adapt_torch.envs.half_cheetah import (  # noqa: F401
    HalfCheetahBlocksEnv, HalfCheetahEnv, HalfCheetahHFieldEnv)
