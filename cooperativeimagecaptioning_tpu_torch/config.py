"""Run options: the JAX package's `config` (the `Options` class, the CLI
parser `parse_opt` and `if_use_att`), shared as is.

A run dir's `infos_<id>.pkl` pickles an `Options` under the JAX package's
module name, so both packages load the same run dirs through this one
class.  Its module imports only the standard library and numpy, never JAX.
"""

from cooperativeimagecaptioning_tpu.config import Options, if_use_att, parse_opt

__all__ = ["Options", "if_use_att", "parse_opt"]
