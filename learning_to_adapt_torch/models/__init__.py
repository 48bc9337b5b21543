"""Learned dynamics models: the GrBAL meta-MLP, the MB-MPC MLP (and its
ensembles) and the ReBAL recurrent model."""
from learning_to_adapt_torch.models.core import params_from_numpy  # noqa: F401
from learning_to_adapt_torch.models.meta_mlp import (  # noqa: F401
    MetaMLPDynamicsModel)
from learning_to_adapt_torch.models.mlp import MLPDynamicsModel  # noqa: F401
from learning_to_adapt_torch.models.normalizer import (  # noqa: F401
    Normalizer, normalizer_from_numpy)
from learning_to_adapt_torch.models.rnn import RNNDynamicsModel  # noqa: F401
