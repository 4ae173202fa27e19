"""Transport / NIC control constants shared by the slot engine and its
kernels (the same values as the reference NIC models)."""
SPX_MD = 0.7
SPX_AI = 0.08
SPX_RTT_GAIN = 0.15
DCQCN_ALPHA_G = 0.0625
DCQCN_AI = 0.01
MIN_RATE = 0.01
TARGET_RTT_US = 12.0
PROBE_TIMEOUT = 3
