"""Model gallery: downloadable model artifacts + async install jobs (copies of
localai_tpu/gallery/, which imports no JAX).

Reference: core/gallery (models.go:75 InstallModelFromGallery, :159
InstallModel, :363 DeleteModelFromSystem; gallery.go:22-80 YAML-over-URI
index fetch) driven through core/services/gallery.go's job queue with
progress polling. Backend-bundle galleries (OCI images keyed on GPU
capability, backends.go:73) have no analogue here — there is one resident
engine, not per-model binaries — so only the *model* gallery is ported.
The starter index (index.yaml here) is a copy of the JAX package's.
"""

from localai_tpu_torch.gallery.gallery import Gallery, GalleryEntry, load_index  # noqa: F401
from localai_tpu_torch.gallery.service import GalleryService, InstallJob  # noqa: F401


def builtin_gallery_url() -> str:
    """file:// URL of the packaged starter index (localai_tpu_torch/gallery/index.yaml)."""
    import os

    return "file://" + os.path.join(os.path.dirname(os.path.abspath(__file__)), "index.yaml")
