"""GoogleNet (Inception-v1) — the paper's native subject (extra arch).

Full ImageNet-scale config (Szegedy et al. 2015) + a CIFAR-scale
``reduced()`` used by the runnable training example and smoke tests.
"""
import dataclasses

from repro_torch.configs.base import CNNConfig, InceptionSpec

CONFIG = CNNConfig(
    name="googlenet", img=(224, 224, 3),
    stem=((7, 64, 2), (1, 64, 1), (3, 192, 1)),
    modules=(
        InceptionSpec(64, 96, 128, 16, 32, 32),      # 3a
        InceptionSpec(128, 128, 192, 32, 96, 64),    # 3b
        InceptionSpec(192, 96, 208, 16, 48, 64),     # 4a
        InceptionSpec(160, 112, 224, 24, 64, 64),    # 4b
        InceptionSpec(128, 128, 256, 24, 64, 64),    # 4c
        InceptionSpec(112, 144, 288, 32, 64, 64),    # 4d
        InceptionSpec(256, 160, 320, 32, 128, 128),  # 4e
        InceptionSpec(256, 160, 320, 32, 128, 128),  # 5a
        InceptionSpec(384, 192, 384, 48, 128, 128),  # 5b
    ),
    pool_between=(0, 2, 7),
    num_classes=1000,
)


def reduced():
    return dataclasses.replace(
        CONFIG, name="googlenet-reduced", img=(32, 32, 3),
        stem=((3, 32, 1),),
        modules=(InceptionSpec(16, 24, 32, 4, 8, 8),
                 InceptionSpec(32, 32, 48, 8, 24, 16)),
        pool_between=(1,),
        num_classes=10)
