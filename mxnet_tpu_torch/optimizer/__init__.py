"""Optimizers of the port."""
from .optimizer import (DCASGD, FTML, LAMB, LARS, LBSGD, NAG, SGD, SGLD,
                        AdaDelta, AdaGrad, Adam, Adamax, AdamW, Ftrl, Nadam,
                        Optimizer, RMSProp, Signum, Updater, create,
                        get_updater, register)

opt_registry = Optimizer.opt_registry

__all__ = ["Optimizer", "SGD", "NAG", "Signum", "FTML", "DCASGD", "SGLD",
           "Adam", "AdamW", "AdaGrad", "AdaDelta", "RMSProp", "Ftrl",
           "Adamax", "Nadam", "LARS", "LBSGD", "LAMB", "Updater", "create",
           "get_updater", "register", "opt_registry"]
