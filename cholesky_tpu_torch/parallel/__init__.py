"""The multi-device tier over ``torch.distributed``: the counterpart of
``cholesky_tpu/parallel`` (the block-cyclic distribute/collect,
potrf/logdet, trsm, trtri/lauum/potri, and the distributed BLAS). One
process per rank; see ``comm.py`` for how the JAX package's collectives
map onto torch's, and ``launch.py`` for starting a world and splitting it
into a (dp, mp) mesh."""

from cholesky_tpu_torch.parallel.blas import (
    gemm_dist,
    herk_dist,
    syrk_dist,
    trmm_dist,
    trsm_dist,
)
from cholesky_tpu_torch.parallel.blockcyclic import (
    BlockCyclic,
    collect,
    distribute,
)
from cholesky_tpu_torch.parallel.launch import Mesh2D, mesh2d
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
