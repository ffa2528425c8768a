from .losses import (
    LOSS_BY_NAME,
    AdaptiveBarronLoss,
    AndrewsWaveLoss,
    BarronGeneralLoss,
    CauchyLoss,
    FairLoss,
    GemanMcClureLoss,
    HuberLoss,
    L1Loss,
    L2Loss,
    Loss,
    LpNormLoss,
    RamsayEaLoss,
    TDistributionLoss,
    TrimmedMeanLoss,
    TukeyBiweightLoss,
    WelschLoss,
)
from .problem import CompiledProblem, FactorGroup, Problem, VarPool

__all__ = ["Problem", "CompiledProblem", "FactorGroup", "VarPool",
           "Loss", "LOSS_BY_NAME", "L2Loss", "L1Loss", "HuberLoss", "CauchyLoss",
           "FairLoss", "GemanMcClureLoss", "WelschLoss", "TukeyBiweightLoss",
           "AndrewsWaveLoss", "RamsayEaLoss", "TrimmedMeanLoss", "LpNormLoss",
           "BarronGeneralLoss", "TDistributionLoss", "AdaptiveBarronLoss"]
