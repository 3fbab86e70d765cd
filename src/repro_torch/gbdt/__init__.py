"""Histogram GBDT on tensors (the cost estimator's regressor): the port of
the JAX package's ``repro.gbdt``."""
from .gbdt import GBDTRegressor
from .tree import RegressionTree

__all__ = ["GBDTRegressor", "RegressionTree"]
