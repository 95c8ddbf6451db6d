"""Configuration dataclasses: ``CNNConfig`` and ``InceptionSpec``
(``repro/models/cnn.py``'s) and ``TrainConfig``
(``repro/configs/base.py``'s), kept field for field."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InceptionSpec:
    n1: int      # 1x1 branch
    r3: int      # 3x3 reduce
    n3: int      # 3x3 branch
    r5: int      # 5x5 reduce
    n5: int      # 5x5 branch
    pp: int      # pool-proj branch

    @property
    def out(self) -> int:
        return self.n1 + self.n3 + self.n5 + self.pp


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str
    img: tuple[int, int, int]            # (H, W, C)
    stem: tuple[tuple[int, int, int], ...]  # (k, out_ch, stride) convs
    modules: tuple[InceptionSpec, ...]
    pool_between: tuple[int, ...]        # module idxs preceded by a maxpool
    num_classes: int = 1000
    family: str = "cnn"

    def param_count(self) -> int:
        n, c = 0, self.img[2]
        for (k, out, _s) in self.stem:
            n += k * k * c * out + out
            c = out
        for m in self.modules:
            n += c * m.n1 + m.n1
            n += c * m.r3 + m.r3 + 9 * m.r3 * m.n3 + m.n3
            n += c * m.r5 + m.r5 + 25 * m.r5 * m.n5 + m.n5
            n += c * m.pp + m.pp
            c = m.out
        return n + c * self.num_classes + self.num_classes


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training knobs (``repro/configs/base.py``'s ``TrainConfig``, kept
    field for field)."""
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    opt_state_dtype: str = "float32"   # "bfloat16" for the 398B config
    param_dtype: str = "float32"
    remat: bool = True
    fsdp: bool = True
    moe_aux_weight: float = 0.01
