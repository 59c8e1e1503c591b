"""The block-cyclic multi-device tier over ``torch.distributed``: the
counterpart of ``cholesky_tpu/parallel`` (distribute/collect,
potrf/logdet, trsm, trtri/lauum/potri). One process per rank; see
``comm.py`` for how the JAX package's collectives map onto torch's, and
``launch.py`` for starting a world."""

from cholesky_tpu_torch.parallel.blockcyclic import (
    BlockCyclic,
    collect,
    distribute,
)
from cholesky_tpu_torch.parallel.potrf import (
    logdet_dist,
    logdet_sharded,
    potrf_dist,
    potrf_sharded,
)
from cholesky_tpu_torch.parallel.trsm import trsm_factor_dist
from cholesky_tpu_torch.parallel.trtri import (
    lauum_dist,
    potri_dist,
    potri_sharded,
    trtri_dist,
)
