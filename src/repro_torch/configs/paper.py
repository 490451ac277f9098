"""The PQS paper's own evaluation models (paper sections 3.1, 4, 5), torch
port of ``repro.configs.paper``: the same three nets at the same widths.

- ``mlp1``: Linear(784 -> 10), the Fig 2 overflow census;
- ``mlp2``: 784 x 784 hidden + 784 x 10 head, the Fig 3 P->Q / Q->P study;
- ``convnet``: two stride-2 3 x 3 convs (16 and 32 channels) on a
  14 x 14 x 4 input, then a 512 -> 10 head, the CIFAR-scale stand-in
  for Figs 4 and 5 (trends, not absolute accuracies).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.pqs import PQSConfig


@dataclasses.dataclass(frozen=True)
class PaperNetConfig:
    name: str
    kind: str  # mlp1 | mlp2 | convnet
    in_dim: int = 784
    hidden: int = 784
    num_classes: int = 10
    # convnet only
    channels: tuple[int, ...] = (16, 32)
    img_hw: int = 14
    pqs: PQSConfig = dataclasses.field(default_factory=PQSConfig)


MLP1 = PaperNetConfig(name="mlp1-mnist", kind="mlp1")
MLP2 = PaperNetConfig(name="mlp2-mnist", kind="mlp2")
CONVNET = PaperNetConfig(name="convnet-cifar-scale", kind="convnet")
