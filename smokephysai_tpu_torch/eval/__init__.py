from .perturbation import PerturbationTester
from .robustness import RobustnessEvaluator

__all__ = ["RobustnessEvaluator", "PerturbationTester"]
