"""Bayesian inference over kernel hyperparameters (NUTS / HMC / SMC / VI).

This layer has no reference counterpart: GraphDot stops at L-BFGS point
estimates (``gaussian_process/base.py:129-148``); this build's north
star is full posteriors with chains/particles sharded across a device mesh
(BASELINE.json).
"""
from .checkpoint import load_chains, resume_state, save_chains
from .diagnostics import ess, split_rhat
from .dual_averaging import da_init, da_update
from .gp_logprob import GPRLogProb
from .gram import GramFactory
from .hmc import HMCState, hmc_init, hmc_step
from .mcmc import sample
from .nuts import nuts_step
from .smc import smc_sample
from .vi import advi

__all__ = [
    'GPRLogProb', 'GramFactory', 'sample', 'nuts_step', 'hmc_step',
    'hmc_init', 'HMCState', 'smc_sample', 'advi', 'split_rhat', 'ess',
    'da_init', 'da_update', 'save_chains', 'load_chains', 'resume_state',
]
