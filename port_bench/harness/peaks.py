"""Published peaks of the cards the benchmark runs on, by the name that
torch.cuda.get_device_name() gives (NVIDIA's data sheet, SXM part, at its
700 W limit)."""
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "memory_bytes": 80e9},
}
