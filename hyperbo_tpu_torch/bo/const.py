"""Method-name constants (port of hyperbo_tpu/bo/const.py), limited to
what `bayesopt._build_model` needs.

The name -> object registries, the dataset registry (HYPERBO_DATASETS) and
the method groupings of `hyperbo_tpu.experiments` wait with the data loaders
(ROADMAP Queue A).
"""

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

# Methods that build an HGP instead of a GP.
USE_HGP = [HBO_SS]
