"""Name -> object registries and method-name constants (port of
hyperbo_tpu/bo/const.py).

MEAN, KERNEL, ACFUN, ACFUN_SUB, EPS and INPUT_SAMPLERS name the port's
objects under the JAX package's keys, with the same method lists. The
dataset registry HYPERBO_DATASETS waits for the data loaders (ROADMAP
Queue A item 8), which it names.
"""

from hyperbo_tpu_torch.bo import acfun
from hyperbo_tpu_torch.bo.input_samplers import INPUT_SAMPLERS  # noqa: F401
from hyperbo_tpu_torch.models import kernel
from hyperbo_tpu_torch.models import mean

MEAN = {
    'constant': mean.constant,
    'linear': mean.linear,
    'linear_mlp': mean.linear_mlp,
    'zero': mean.zero,
}

KERNEL = {
    'squared_exponential': kernel.squared_exponential,
    'matern32': kernel.matern32,
    'matern52': kernel.matern52,
    'dot_product': kernel.dot_product,
    'dot_product_mlp': kernel.dot_product_mlp,
    'squared_exponential_mlp': kernel.squared_exponential_mlp,
    'matern32_mlp': kernel.matern32_mlp,
    'matern52_mlp': kernel.matern52_mlp,
}

ACFUN = {
    'expected_improvement': acfun.expected_improvement,
    'probability_of_improvement': acfun.probability_of_improvement,
    'ucb3': acfun.ucb3,
    'random_search': acfun.random_search,
    'ucb2': acfun.ucb2,
    'ucb': acfun.ucb,
    'thompson_sampling': acfun.thompson_sampling,
}

ACFUN_SUB = {
    'expected_improvement': acfun.expected_improvement_sub,
    'probability_of_improvement': acfun.probability_of_improvement_sub,
    'ucb': acfun.ucb_sub,
}

EPS = 1e-6

# Offline experiment method names.
RAND = 'rand'
STBO = 'stbo'
MTBO = 'mtbo'
STBOV = 'gp'
HBO = 'hyperbo'
HBO_SS = 'hyperbo_ss'
HBO_NLL = 'hyperbo_nll'
HBO_NLLKL = 'hyperbo_nllkl'
HBO_NLLEUC = 'hyperbo_nlleuc'

CONTEXTUAL_METHODS = ['rfgp', 'mimo', STBOV]

HBO_METHODS = [HBO_SS, HBO_NLL, HBO_NLLKL, HBO_NLLEUC]
OFFLINE_METHODS = [RAND, STBO, MTBO, HBO, HBO_SS] + CONTEXTUAL_METHODS

ONLINE_METHODS = [STBO, MTBO] + HBO_METHODS
# Methods that build an HGP instead of a GP.
USE_HGP = [HBO_SS]
ST_METHODS = [STBO, STBOV]
