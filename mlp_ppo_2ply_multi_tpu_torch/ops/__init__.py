"""The port's hand-written kernels. Importing the package registers the
tracer's stamp writer (``stamp``) with ``utils.profiling``."""
from mlp_ppo_2ply_multi_tpu_torch.ops import stamp  # noqa: F401
