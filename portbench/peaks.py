"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives: NVIDIA's data sheet for the H100 SXM
part, dense rates without sparsity, at the full 700 W power limit (a card
set lower runs slower; the run records the limit beside its numbers)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,          # float32 outside the tensor cores
        "hbm_bytes_per_s": 3.35e12,
    },
}
