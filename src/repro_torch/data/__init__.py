"""Synthetic data of the port (numpy), the copy of ``repro.data``."""

from repro_torch.data.pipeline import (  # noqa: F401
    ClassificationDataset,
    TokenStream,
    make_classification,
    synth_mnist,
)
