"""Many channels of one stream on one card (``channel_bank``), and the
JAX package's multi-device patterns over ``torch.distributed``: sharded
MUSIC (``doa``), the tap-sharded FIR (``tp``), the (chan x time) WBFM
bank (``wbfm_bank``) and the stage pipeline (``pipeline``)."""
