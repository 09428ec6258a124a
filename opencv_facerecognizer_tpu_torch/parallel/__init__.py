"""The gallery and the serving step, on one device or over a device mesh
(``mesh``: ``dp`` splits frame and query batches, ``tp`` the gallery's
rows). ``TwoStagePipeline`` and ``split_mesh`` load lazily (they pull in
the model stack); ``CoarseQuantizer`` too."""

from opencv_facerecognizer_tpu_torch.parallel.gallery import (
    EmbeddingDimMismatchError,
    ShardedGallery,
)
from opencv_facerecognizer_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

__all__ = ["CoarseQuantizer", "EmbeddingDimMismatchError", "ShardedGallery",
           "TwoStagePipeline", "initialize_multihost", "make_mesh", "split_mesh"]


def __getattr__(name):
    if name in ("TwoStagePipeline", "split_mesh"):
        from opencv_facerecognizer_tpu_torch.parallel import pp

        return getattr(pp, name)
    if name == "CoarseQuantizer":
        from opencv_facerecognizer_tpu_torch.parallel.quantizer import CoarseQuantizer

        return CoarseQuantizer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
