"""torch_scan_ms: device ms a traced frame in torch's own scan kernels,
the ones `torch.cumsum` and `torch.cummax` launch, matched by kind
against the list below (frozen from a trace of the program on an H100)."""

from metrics._common import kernel_ms_per_frame

SCAN_KINDS = (
    "at::native::tensor_kernel_scan_outer_dim",
    "at::native::tensor_kernel_scan_innermost_dim",
    "at::native::tensor_kernel_scan_outer_dim_with_indices",
    "at::native::tensor_kernel_scan_innermost_dim_with_indices",
    "at_cuda_detail::cub::DeviceScanKernel",
    "at_cuda_detail::cub::DeviceScanInitKernel",
    "at_cuda_detail::cub::DeviceScanByKeyKernel",
    "at_cuda_detail::cub::DeviceScanByKeyInitKernel",
)


def read(ctx):
    trace = ctx.get("trace")
    return kernel_ms_per_frame(trace, lambda kind: kind in SCAN_KINDS) if trace else None
