"""The paper's own experimental model: CNN (2 conv + 1 FC) on MNIST/CIFAR-
shaped data, 10 edge nodes (3 malicious), lr=0.001, B=128 (paper §6.1)."""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class PaperCNNConfig:
    dataset: str = "mnist"       # "mnist" (28x28x1) | "cifar" (32x32x3)
    n_nodes: int = 10
    n_malicious: int = 3
    lr: float = 1e-3
    batch_size: int = 128
    flip_src: int = 1            # MNIST '1' -> '7'
    flip_dst: int = 7
    epsilon: float = 8.0
    delta: float = 1e-3
    alpha: float = 0.5
    detect_s: float = 80.0

    @property
    def hw(self) -> Tuple[int, int]:
        return (28, 28) if self.dataset == "mnist" else (32, 32)

    @property
    def channels(self) -> int:
        return 1 if self.dataset == "mnist" else 3


def config() -> PaperCNNConfig:
    return PaperCNNConfig()
