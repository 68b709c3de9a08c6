"""Operations, bytes and published peaks: the yardstick of the
roofline and MFU metrics.  Kernel counts are frozen copies of
``chip_smoke.py``'s functions; one module per kernel or model family."""
