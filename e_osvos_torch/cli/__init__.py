"""Command lines of the PyTorch port: ``evaluate`` (one-shot evaluation of a
dataset, J/F and palette PNGs) and ``train_meta`` (meta-training), over the
layered YAML configuration of ``e_osvos_torch.config``."""
