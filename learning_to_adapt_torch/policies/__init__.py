"""MPC policies: random shooting and CEM, feed-forward and recurrent."""
from learning_to_adapt_torch.policies.base import Policy  # noqa: F401
from learning_to_adapt_torch.policies.controllers import (  # noqa: F401
    MPCController, RNNMPCController)
