"""CUDA kernels of the port (sources in ``../csrc``), each beside its plain
PyTorch version in ``ref``.  Importing a module here builds and loads
nothing: a kernel is compiled on its first launch."""


def launches() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from . import attention, mesh_scan, onn_layer, paged_attention, pam4
    return {fn.__name__: fn.launches for fn in (
        attention.flash_attention, attention.flash_attention_bwd,
        pam4.pam4_quantize_encode, pam4.pam4_decode_dequantize,
        onn_layer.onn_layer, mesh_scan.mesh_scan_blocks,
        paged_attention.paged_attention)}
