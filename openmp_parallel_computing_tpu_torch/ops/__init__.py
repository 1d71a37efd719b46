"""Image ops of the PyTorch port: hand-written CUDA kernels, each with its
plain PyTorch twin (stencils, conv, reductions), and the kernel
registry."""

from openmp_parallel_computing_tpu_torch.ops import xla_ref  # noqa: F401
from openmp_parallel_computing_tpu_torch.ops.conv import (  # noqa: F401
    conv3x3,
    gaussian_blur,
)
from openmp_parallel_computing_tpu_torch.ops.grayscale import grayscale  # noqa: F401
from openmp_parallel_computing_tpu_torch.ops.pipeline import (  # noqa: F401
    edge_pipeline,
    edge_pyramid_base,
)
from openmp_parallel_computing_tpu_torch.ops.reductions import (  # noqa: F401
    channel_mean,
    channel_sum,
    grayscale_mean_minmax,
)
from openmp_parallel_computing_tpu_torch.ops.sobel import sobel  # noqa: F401
from openmp_parallel_computing_tpu_torch.ops.xla_ref import (  # noqa: F401
    chw_to_hwc,
    hwc_to_chw,
)
from openmp_parallel_computing_tpu_torch.ops.runner import (  # noqa: F401
    KernelSpec,
    kernel_names,
    make_runner,
    register_kernel,
    unregister_kernel,
)
