"""The paper's CNN family (ResNet18 / VGG16 / MobileNetV2) on the port's
quantized-training engine (port of ``repro.cnn``)."""
from .models import (  # noqa: F401
    MOBILENETV2_TINY,
    RESNET18_TINY,
    VGG16_TINY,
    CNNConfig,
    apply_cfg,
    bench_config,
    init,
    init_sites,
    loss_fn,
)
from .train import make_cnn_train_step, train_cnn  # noqa: F401
