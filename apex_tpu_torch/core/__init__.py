from .losses import HuberLoss, L2Loss, Loss
from .problem import CompiledProblem, FactorGroup, Problem, VarPool

__all__ = ["Problem", "CompiledProblem", "FactorGroup", "VarPool",
           "Loss", "L2Loss", "HuberLoss"]
