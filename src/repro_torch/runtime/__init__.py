"""Runtime of the port: accumulator-aware fine-tuning and certification
(``runtime.qat``)."""

from repro_torch.runtime.qat import (  # noqa: F401
    QATConfig,
    a2q_finetune,
    quantize_and_certify,
)
