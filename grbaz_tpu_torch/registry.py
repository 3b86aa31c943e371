"""Block registry — the framework's component catalog and taxonomy.

The reference ships 71 GRC block descriptors organized by a category
tree (the reference's grc/baz.tree.yml: Sources / Sinks / Networking /
GUI / Any Blocks / Basics / Analog / Digital / Math / Burst Management /
Synchronisers / State / Messaging / Multi-channel / Applications /
Legacy / Testing). This framework has no GRC XML layer — the Python API
*is* the framework API (SURVEY.md §7 "what NOT to rebuild") — but the
catalog itself is a capability: tooling (and users) can enumerate what
exists, look components up by name, and resolve them to live classes.

Each entry: ``name -> (category, "module:attr", reference analog)``.
``resolve()`` imports and returns the object; a unit test resolves every
entry, so the registry cannot drift from the code.

The port's copy of ``grbaz_tpu/registry.py``: host code, its imports
pointed into ``grbaz_tpu_torch``.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Tuple

# name: (category, "module:attr", reference analog)
REGISTRY: Dict[str, Tuple[str, str, str]] = {
    # -- Sources -----------------------------------------------------------
    "file_source": ("Sources", "grbaz_tpu_torch.io.file_source:FileSource",
                    "lib/baz_file_source.cc"),
    "rtl_source": ("Sources", "grbaz_tpu_torch.io.rtl_source:RTLSource",
                   "lib/baz_rtl_source_c.cc"),
    # -- Sinks ---------------------------------------------------------------
    "baudline_sink": ("Sinks", "grbaz_tpu_torch.compat.baudline:BaudlineSink",
                      "python/baudline.py"),
    "waterfall_sink": ("Sinks", "grbaz_tpu_torch.viz.sinks:WaterfallSink",
                       "python/waterfall_sink.py + lib/baz_sdl_sink_uc.cc"),
    "plot_sink": ("Sinks", "grbaz_tpu_torch.viz.sinks:PlotSink",
                  "python/plot_sink.py"),
    "eye_sink": ("Sinks", "grbaz_tpu_torch.viz.sinks:EyeSink", "python/eye.py"),
    "histo_sink": ("Sinks", "grbaz_tpu_torch.viz.sinks:HistoSink",
                   "samples/tutorial/part-01 histo sink"),
    # -- Networking ----------------------------------------------------------
    "borip_server": ("Networking", "grbaz_tpu_torch.net.borip_server:BorIPServer",
                     "python/borip_server.py"),
    "borip_client": ("Networking", "grbaz_tpu_torch.net.borip_client:RemoteDevice",
                     "python/borip.py"),
    "udp_source": ("Networking", "grbaz_tpu_torch.net.udp:UDPSampleReceiver",
                   "lib/baz_udp_source.cc"),
    "udp_sink": ("Networking", "grbaz_tpu_torch.net.udp:UDPSampleSender",
                 "lib/baz_udp_sink.cc"),
    "tcp_source": ("Networking", "grbaz_tpu_torch.net.tcp:TCPFrameSource",
                   "lib/baz_tcp_source.cc"),
    "tcp_sink": ("Networking", "grbaz_tpu_torch.net.tcp:TCPFrameSink",
                 "lib/baz_tcp_sink.cc"),
    "tcp_source_native": ("Networking",
                          "grbaz_tpu_torch.net.tcp:NativeTCPFrameSource",
                          "lib/baz_tcp_source.cc"),
    "tcp_sink_native": ("Networking", "grbaz_tpu_torch.net.tcp:NativeTCPFrameSink",
                        "lib/baz_tcp_sink.cc"),
    "borip_remote_device": ("Networking",
                            "grbaz_tpu_torch.net.devices:BorIPRemoteDevice",
                            "python/borip.py remote_usrp + :561-573"),
    "control_server": ("Networking",
                       "grbaz_tpu_torch.net.control_server:ControlServer",
                       "python/introspective_xmlrpc_server.py"),
    # -- Basics --------------------------------------------------------------
    "delay": ("Basics", "grbaz_tpu_torch.ops.basic:VariableDelay",
              "lib/baz_delay.cc"),
    "gate": ("Basics", "grbaz_tpu_torch.ops.burst:Gate", "lib/baz_gate.cc"),
    "non_blocker": ("Basics", "grbaz_tpu_torch.ops.burst:NonBlocker",
                    "lib/baz_non_blocker.cc"),
    "swap_iq": ("Basics", "grbaz_tpu_torch.ops.basic:SwapIQ", "lib/baz_swap.cc"),
    "swap_ff": ("Basics", "grbaz_tpu_torch.ops.misc:SwapFF", "lib/baz_swap_ff.cc"),
    "keep_one_in_n": ("Basics", "grbaz_tpu_torch.ops.basic:KeepOneInN",
                      "lib/baz_keep_one_in_n.cc"),
    "overlap": ("Basics", "grbaz_tpu_torch.ops.spectral:Overlap",
                "lib/baz_overlap.cc"),
    "interleaver": ("Basics", "grbaz_tpu_torch.ops.misc:MatrixInterleaver",
                    "lib/baz_interleaver.cc"),
    "unpacked_to_packed": ("Basics", "grbaz_tpu_torch.ops.basic:UnpackedToPacked",
                           "lib/baz_unpacked_to_packed_bb.cc"),
    "print_char": ("Basics", "grbaz_tpu_torch.utils.debug:PrintChar",
                   "lib/baz_print_char.cc"),
    # -- Analog --------------------------------------------------------------
    "agc": ("Analog", "grbaz_tpu_torch.ops.agc:AGC", "lib/baz_agc_cc.cc"),
    "quadrature_demod": ("Analog", "grbaz_tpu_torch.ops.demod:QuadratureDemod",
                         "host GR (RTL-FM.grc chain)"),
    "power_squelch": ("Analog", "grbaz_tpu_torch.ops.demod:PowerSquelch",
                      "host GR (RTL-FM.grc chain)"),
    "fm_deemphasis": ("Analog", "grbaz_tpu_torch.ops.demod:FMDeemphasis",
                      "host GR (RTL-FM.grc chain)"),
    "am_demod": ("Analog", "grbaz_tpu_torch.ops.demod:AMDemod",
                 "apps/am_fft.py magnitude path"),
    "sweep": ("Analog", "grbaz_tpu_torch.ops.burst:Sweep", "lib/baz_sweep.cc"),
    # -- Digital -------------------------------------------------------------
    "additive_scrambler": ("Digital", "grbaz_tpu_torch.ops.fec:AdditiveScrambler",
                           "lib/baz_additive_scrambler_bb.cc"),
    "auto_fec": ("Digital", "grbaz_tpu_torch.models.auto_fec:AutoFEC",
                 "python/auto_fec.py"),
    "fec_sync": ("Digital", "grbaz_tpu_torch.models.fec_sync:FECSync",
                 "python/fec_sync.py"),
    "puncture": ("Digital", "grbaz_tpu_torch.ops.fec:Puncture",
                 "lib/baz_puncture_bb.cc"),
    "depuncture": ("Digital", "grbaz_tpu_torch.ops.fec:Depuncture",
                   "lib/baz_depuncture_ff.cc"),
    "viterbi": ("Digital", "grbaz_tpu_torch.ops.fec:viterbi_decode",
                "host GR trellis (auto_fec chain)"),
    "pn_ber": ("Digital", "grbaz_tpu_torch.ops.fec:PNBERv",
               "lib/baz_auto_ber_bf.cc"),
    "glfsr_source": ("Digital", "grbaz_tpu_torch.ops.fec:GLFSRSource",
                     "host GR glfsr_source_b (samples/tutorial stimulus)"),
    "hysteresis": ("Digital", "grbaz_tpu_torch.ops.basic:Hysteresis",
                   "host GR threshold_ff (samples/tutorial/part-02)"),
    "manchester_decode": ("Digital", "grbaz_tpu_torch.ops.decode:ManchesterDecode",
                          "lib/baz_manchester_decode_bb.cc"),
    # -- Math ----------------------------------------------------------------
    "pow_cc": ("Math", "grbaz_tpu_torch.ops.basic:PowCC", "lib/baz_pow_cc.cc"),
    "colouriser": ("Math", "grbaz_tpu_torch.ops.colour:Colouriser",
                   "lib/baz_colouriser.cc"),
    # -- Burst Management ------------------------------------------------------
    "burster": ("Burst Management", "grbaz_tpu_torch.ops.burst:Burster",
                "lib/baz_burster.cc"),
    "burster_config": ("Burst Management", "grbaz_tpu_torch.ops.burst:BursterConfig",
                       "lib/baz_burster_config.h"),
    "burst_tagger": ("Burst Management", "grbaz_tpu_torch.ops.burst:BurstTagger",
                     "lib/baz_burst_tagger_impl.cc"),
    "burst_buffer": ("Burst Management", "grbaz_tpu_torch.ops.burst:BurstBuffer",
                     "lib/baz_burst_buffer.cc"),
    "merge": ("Burst Management", "grbaz_tpu_torch.ops.burst:Merge",
              "lib/baz_merge.cc"),
    "time_keeper": ("Burst Management", "grbaz_tpu_torch.ops.burst:TimeKeeper",
                    "lib/baz_time_keeper.cc"),
    # -- Synchronisers ---------------------------------------------------------
    "dpll_bit_sync": ("Synchronisers", "grbaz_tpu_torch.ops.decode:DPLLBitSync",
                      "lib/baz_dpll_bb.cc"),
    "fractional_resampler": ("Synchronisers",
                             "grbaz_tpu_torch.ops.resampler:FractionalResampler",
                             "lib/baz_fractional_resampler_cc.cc"),
    "variable_ratio_resampler": (
        "Synchronisers", "grbaz_tpu_torch.ops.resampler:VariableRatioResampler",
        "lib/baz_fractional_resampler_cc.cc:200-217 (ratio-stream mode)"),
    "rate_synchroniser": ("Synchronisers",
                          "grbaz_tpu_torch.net.rate_synchroniser:RateSynchroniser",
                          "python/rate_synchroniser.py"),
    "field_tracker": ("Synchronisers", "grbaz_tpu_torch.ops.misc:FieldTracker",
                      "lib/baz_field_tracker.cc"),
    # -- State -----------------------------------------------------------------
    "block_status": ("State", "grbaz_tpu_torch.ops.misc:BlockStatus",
                     "lib/baz_block_status.cc"),
    "run_remote": ("State", "grbaz_tpu_torch.utils.run_remote:RunRemote",
                   "grc/baz_run_remote.xml"),
    "checkpoint": ("State", "grbaz_tpu_torch.core.checkpoint:save_state",
                   "new capability (SURVEY.md §5)"),
    # -- Messaging ---------------------------------------------------------------
    "message_server": ("Messaging", "grbaz_tpu_torch.net.message_server:MessageServer",
                       "python/message_server.py"),
    "message_relay": ("Messaging", "grbaz_tpu_torch.net.message_server:MessageRelay",
                      "python/message_relay.py"),
    "message_callback": ("Messaging",
                         "grbaz_tpu_torch.net.message_server:MessageCallback",
                         "python/message_callback.py"),
    "event_to_message": ("Messaging",
                         "grbaz_tpu_torch.net.message_server:EventToMessage",
                         "lib/baz_tag_to_msg.cc"),
    # -- Multi-channel -------------------------------------------------------------
    "channel_bank": ("Multi-channel",
                     "grbaz_tpu_torch.parallel.channel_bank:DynamicChannelBank",
                     "python/multi_channel_decoder.py"),
    "wbfm_bank": ("Multi-channel", "grbaz_tpu_torch.parallel.wbfm_bank:ShardedWBFMBank",
                  "python/multi_channel_decoder.py (sharded)"),
    "stage_pipeline": ("Multi-channel",
                       "grbaz_tpu_torch.parallel.pipeline:StagePipeline",
                       "host GR thread-per-block pipeline (SURVEY.md §2.4)"),
    "tp_fir": ("Multi-channel", "grbaz_tpu_torch.parallel.tp:TPFIRDecimator",
               "new capability (weight-sharded kernels)"),
    # -- Applications ----------------------------------------------------------------
    "radar_detector": ("Applications/RADAR", "grbaz_tpu_torch.ops.detect:RadarDetector",
                       "lib/baz_radar_detector.cc"),
    "radar_server": ("Applications/RADAR", "grbaz_tpu_torch.net.radar_server:RadarServer",
                     "python/radar_server.py"),
    "acars_decoder": ("Applications/ACARS", "grbaz_tpu_torch.ops.decode:ACARSDecoder",
                      "lib/baz_acars_decoder.cc"),
    "acars_printer": ("Applications/ACARS", "grbaz_tpu_torch.utils.acars:format_packet",
                      "python/acars_printer.py"),
    "music_doa": ("Applications/DOA", "grbaz_tpu_torch.ops.doa:music_spectrum",
                  "lib/baz_music_doa.cc"),
    "doa_compass": ("Applications/DOA", "grbaz_tpu_torch.viz.sinks:DoACompass",
                    "python/doa_compass_plotter.py"),
    "fsk4_demod": ("Applications/P25", "grbaz_tpu_torch.ops.fsk4:FSK4Demod",
                   "python/baz_op25.py op25_fsk4"),
    "p25_frame_sync": ("Applications/P25", "grbaz_tpu_torch.ops.p25:P25FrameSync",
                       "python/baz_op25.py op25_decoder"),
    "p25_rx": ("Applications/P25", "grbaz_tpu_torch.models.p25:build_p25_rx",
               "python/baz_op25.py"),
    "op25_traffic": ("Applications/P25", "grbaz_tpu_torch.viz.traffic:TrafficPane",
                     "python/op25_traffic_pane.py"),
    "p25_voice": ("Applications/P25",
                  "grbaz_tpu_torch.models.p25_voice:P25VoiceDecoder",
                  "python/baz_op25.py DES key glue"),
    "p25_wire_voice": ("Applications/P25",
                       "grbaz_tpu_torch.models.p25_voice:P25WireVoiceDecoder",
                       "python/baz_op25.py + op25 OOT LDU framing role"),
    "p25_ldu": ("Applications/P25", "grbaz_tpu_torch.ops.p25_ldu:build_ldu",
                "op25 OOT TIA-102 frame schedule role"),
    "p25_fec": ("Applications/P25", "grbaz_tpu_torch.ops.p25_fec:golay23_encode",
                "op25 OOT Golay/Hamming/RS role"),
    "fastrak_decoder": ("Applications/FasTrak",
                        "grbaz_tpu_torch.ops.misc:FastrakDecoder",
                        "lib/baz_fastrak_decoder.cc"),
    "missile_launcher": ("Applications",
                         "grbaz_tpu_torch.utils.missile_launcher:MissileLauncher",
                         "python/missile_launcher.py"),
    # -- Detection helpers --------------------------------------------------------------
    "peak_detector": ("Applications", "grbaz_tpu_torch.ops.detect:PeakDetector",
                      "lib/baz_peak_detector.cc"),
    "correlator": ("Applications", "grbaz_tpu_torch.ops.detect:Correlator",
                   "lib/baz_correlator.cc"),
    # -- Any Blocks ------------------------------------------------------------------
    "any_block": ("Any Blocks", "grbaz_tpu_torch.core.block:AnyBlock",
                  "grc/baz_any_x.xml"),
    "any_code": ("Any Blocks", "grbaz_tpu_torch.core.block:any_code",
                 "grc/baz_any_code.xml"),
    # -- Legacy ----------------------------------------------------------------------
    "usrp_legacy": ("Legacy", "grbaz_tpu_torch.compat.usrp:source_c",
                    "python/usrp.py"),
    "usrp_simple": ("Legacy", "grbaz_tpu_torch.compat.usrp:simple_source_c",
                    "python/usrp/simple_usrp.py"),
    "usrp_dual": ("Legacy", "grbaz_tpu_torch.compat.usrp:dual_source_c",
                  "python/usrp/dual_usrp.py"),
    # -- Testing ---------------------------------------------------------------------
    "test_counter": ("Testing", "grbaz_tpu_torch.ops.misc:TestCounter",
                     "lib/baz_test_counter_cc.cc"),
    # -- Hardware control ---------------------------------------------------------------
    "freq_hopper": ("Hardware", "grbaz_tpu_torch.net.hw_control:FreqHopper",
                    "python/freq_hopper.py + lib/baz_hopper.cc"),
    "hopper_demux": ("Hardware", "grbaz_tpu_torch.ops.hopper:HopperDemux",
                     "lib/baz_hopper.cc (chunk demux)"),
    "software_agc": ("Hardware", "grbaz_tpu_torch.net.hw_control:SoftwareAGC",
                     "python/usrp_agc.py"),
    "gpsdo_monitor": ("Hardware", "grbaz_tpu_torch.net.hw_control:GPSDOMonitor",
                      "apps/gpsdo.py"),
    "delayed_start": ("Hardware", "grbaz_tpu_torch.net.hw_control:delayed_start",
                      "python/delayed_start.py"),
    "finite_acquisition": ("Hardware",
                           "grbaz_tpu_torch.net.hw_control:finite_acquisition",
                           "lib/baz_usrp_acquire.cc"),
}


def resolve(name: str) -> Any:
    """Import and return the live object for a registry entry."""
    _cat, path, _ref = REGISTRY[name]
    module, attr = path.split(":")
    return getattr(importlib.import_module(module), attr)


def categories() -> List[str]:
    return sorted({cat for cat, _, _ in REGISTRY.values()})


def blocks_by_category(category: str) -> Dict[str, Tuple[str, str]]:
    """{name: (module:attr, reference analog)} for one category."""
    return {n: (p, r) for n, (c, p, r) in REGISTRY.items() if c == category}


def find(substr: str) -> List[str]:
    """Case-insensitive name search."""
    s = substr.lower()
    return sorted(n for n in REGISTRY if s in n.lower())


def tree() -> str:
    """Render the taxonomy as text (the baz.tree.yml analog)."""
    lines = ["[grbaz_tpu_torch]"]
    for cat in categories():
        lines.append(f"  {cat}:")
        for n, (p, _r) in sorted(blocks_by_category(cat).items()):
            lines.append(f"    - {n}  ({p})")
    return "\n".join(lines)
