"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the yardstick's rooflines and
model-FLOP shares are taken against these, with the card's power limit
printed beside them."""

HBM_BYTES_PER_S = 3.35e12

# dense FLOP/s by the precision a configuration states
FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,  # outside the tensor cores, TF32 off
}
