"""The gallery, the serving step and the ArcFace training step, on one
device or over a device mesh (``mesh``: ``dp`` splits frame, query and
training batches, ``tp`` the gallery's rows and the ArcFace head's
classes). ``TwoStagePipeline``, ``split_mesh`` and ``ShardedArcFaceStep``
load lazily (they pull in the model stack); ``CoarseQuantizer`` too."""

from opencv_facerecognizer_tpu_torch.parallel.gallery import (
    EmbeddingDimMismatchError,
    ShardedGallery,
)
from opencv_facerecognizer_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

__all__ = ["CoarseQuantizer", "EmbeddingDimMismatchError", "ShardedArcFaceStep",
           "ShardedGallery", "TwoStagePipeline", "initialize_multihost", "make_mesh",
           "split_mesh"]


def __getattr__(name):
    if name in ("TwoStagePipeline", "split_mesh"):
        from opencv_facerecognizer_tpu_torch.parallel import pp

        return getattr(pp, name)
    if name == "ShardedArcFaceStep":
        from opencv_facerecognizer_tpu_torch.parallel.train import ShardedArcFaceStep

        return ShardedArcFaceStep
    if name == "CoarseQuantizer":
        from opencv_facerecognizer_tpu_torch.parallel.quantizer import CoarseQuantizer

        return CoarseQuantizer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
