"""Published peaks of the chips the benchmark runs on (NVIDIA's data
sheets, SXM parts, dense rates without sparsity, at the full power
limit), looked up by ``torch.cuda.get_device_name()``."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "fp8_flops": 1979e12,
                              "fp32_flops": 67e12, "hbm_bytes": 3.35e12,
                              "power_w": 700.0},
}


def peaks(kind: str) -> dict:
    for name, p in PEAKS.items():
        if kind.startswith(name) or name.startswith(kind):
            return p
    raise KeyError(f"no published peaks for {kind!r}: add the part's data "
                   f"sheet rates to bench/lib/peaks.py")
