"""Network plane: BorIP remote-SDR protocol, control and sample planes
(port of ``grbaz_tpu/net``). The UDP hot path is native C++
(``grbaz_tpu_torch/native/boripnet.cc``)."""
