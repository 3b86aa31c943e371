// GENERATED by tools/extract_tuner_tables.py — register DATA tables
// extracted from the reference drivers (hardware facts):
//   the reference's lib/rtl2832-tuner_r820t.cc (R828_iniArry,
//   R828_Freq_Sel, r820t_*_gain_steps, R828_Sys/SysFreq constants)
//   the reference's lib/rtl2832-tuner_e4000.cc (PLL band table,
//   sub-band/LNA-filter/IF-filter chains, _mapGainsE4000, init writes)
// Do not edit by hand; re-run the extractor.
#pragma once
#include <cstdint>

namespace rtl { namespace tables {

// R828 initial register values for regs 0x05..0x1F (TUNER_CLK_OUT=TRUE
// variant is the compiled one in the reference, line ~404)
static const uint8_t kR820TInit[27] = {0x83, 0x32, 0x75, 0xC0, 0x40, 0xD6, 0x6C, 0xF5, 0x63, 0x75, 0x68, 0x6C, 0x83, 0x80, 0x00, 0x0F, 0x00, 0xC0, 0x30, 0x48, 0xCC, 0x60, 0x00, 0x54, 0xAE, 0x4A, 0xC0};

// R828_Freq_Sel band table: upper LO bound (kHz, exclusive; last row
// open-ended) -> open_d, rf_mux_ploy, tf_c, xtal_cap 20p/10p/0p
struct R820TBand { uint32_t lo_khz_below; uint8_t open_d, rf_mux_ploy,
                   tf_c, cap20p, cap10p, cap0p; };
static const R820TBand kR820TBands[21] = {
  {50000u, 0x08, 0x02, 0xDF, 0x02, 0x01, 0x00},
  {55000u, 0x08, 0x02, 0xBE, 0x02, 0x01, 0x00},
  {60000u, 0x08, 0x02, 0x8B, 0x02, 0x01, 0x00},
  {65000u, 0x08, 0x02, 0x7B, 0x02, 0x01, 0x00},
  {70000u, 0x08, 0x02, 0x69, 0x02, 0x01, 0x00},
  {75000u, 0x08, 0x02, 0x58, 0x02, 0x01, 0x00},
  {80000u, 0x00, 0x02, 0x44, 0x02, 0x01, 0x00},
  {90000u, 0x00, 0x02, 0x44, 0x02, 0x01, 0x00},
  {100000u, 0x00, 0x02, 0x34, 0x01, 0x01, 0x00},
  {110000u, 0x00, 0x02, 0x34, 0x01, 0x01, 0x00},
  {120000u, 0x00, 0x02, 0x24, 0x01, 0x01, 0x00},
  {140000u, 0x00, 0x02, 0x24, 0x01, 0x01, 0x00},
  {180000u, 0x00, 0x02, 0x14, 0x01, 0x01, 0x00},
  {220000u, 0x00, 0x02, 0x13, 0x00, 0x00, 0x00},
  {250000u, 0x00, 0x02, 0x13, 0x00, 0x00, 0x00},
  {280000u, 0x00, 0x02, 0x11, 0x00, 0x00, 0x00},
  {310000u, 0x00, 0x02, 0x00, 0x00, 0x00, 0x00},
  {450000u, 0x00, 0x41, 0x00, 0x00, 0x00, 0x00},
  {588000u, 0x00, 0x41, 0x00, 0x00, 0x00, 0x00},
  {650000u, 0x00, 0x40, 0x00, 0x00, 0x00, 0x00},
  {4294967295u, 0x00, 0x40, 0x00, 0x00, 0x00, 0x00},
};

static const int kR820T_vga_gain_steps[16] = {0, 26, 26, 30, 42, 35, 24, 13, 14, 32, 36, 34, 35, 37, 35, 36};  // tenth-dB
static const int kR820T_lna_gain_steps[16] = {0, 9, 13, 40, 38, 13, 31, 22, 26, 31, 26, 14, 19, 5, 35, 13};  // tenth-dB
static const int kR820T_mixer_gain_steps[16] = {0, 5, 10, 10, 19, 9, 10, 25, 17, 10, 8, 16, 13, 6, 3, -8};  // tenth-dB
static const int kR820T_vga_base_gain = -47;

// Sys_Sel(DVB_T_6M) — the wrapper's fixed standard (r820t_SetRfFreqHz)
static const uint32_t kR820T_if_khz = 3570;
static const uint8_t kR820T_sys_FILT_GAIN = 0x10;
static const uint8_t kR820T_sys_IMG_R = 0x00;
static const uint8_t kR820T_sys_FILT_Q = 0x10;
static const uint8_t kR820T_sys_HP_COR = 0x6B;
static const uint8_t kR820T_sys_EXT_ENABLE = 0x60;
static const uint8_t kR820T_sys_LOOP_THROUGH = 0x00;
static const uint8_t kR820T_sys_LT_ATT = 0x00;
static const uint8_t kR820T_sys_FLT_EXT_WIDEST = 0x00;
static const uint8_t kR820T_sys_POLYFIL_CUR = 0x60;

// SysFreq_Sel(DVB_T, rf): spot frequencies 506/666/818 MHz use the
// alternate MIXER_TOP/CP_CUR/DIV_BUF_CUR row
static const uint8_t kR820T_mixer_top = 0x24;
static const uint8_t kR820T_mixer_top_spot = 0x14;
static const uint8_t kR820T_lna_top = 0xE5;
static const uint8_t kR820T_cp_cur = 0x38;
static const uint8_t kR820T_cp_cur_spot = 0x28;
static const uint8_t kR820T_div_buf_cur = 0x30;
static const uint8_t kR820T_div_buf_cur_spot = 0x20;
static const uint8_t kR820T_sysf_LNA_VTH_L = 0x53;
static const uint8_t kR820T_sysf_MIXER_VTH_L = 0x75;
static const uint8_t kR820T_sysf_AIR_CABLE1_IN = 0x00;
static const uint8_t kR820T_sysf_CABLE2_IN = 0x00;
static const uint8_t kR820T_sysf_FILTER_CUR = 0x40;

// E4000 PLL band table: freq (kHz, inclusive upper bound) -> reg 0x0D
// value + VCO multiplier (reference PLL(), rtl2832-tuner_e4000.cc)
struct E4000PLLBand { uint32_t khz_max; uint8_t reg0d; uint8_t mult; };
static const E4000PLLBand kE4000PLL[11] = {
  {72400u, 15, 48},
  {81200u, 14, 40},
  {108300u, 13, 32},
  {162500u, 12, 24},
  {216600u, 11, 16},
  {325000u, 10, 12},
  {350000u, 9, 8},
  {432000u, 3, 8},
  {667000u, 2, 6},
  {1200000u, 1, 4},
  {4294967295u, 0, 2},
};

// E4000 PLL sub-band chain -> reg 0x05 (bias) / reg 0x07 (sub-band)
struct E4000SubBand { uint32_t khz_max; uint8_t reg05; uint8_t reg07; };
static const E4000SubBand kE4000Sub[42] = {
  {82900u, 0, 1},
  {89900u, 3, 9},
  {111700u, 0, 1},
  {118700u, 3, 1},
  {140500u, 0, 3},
  {147500u, 3, 11},
  {169300u, 0, 3},
  {176300u, 3, 11},
  {198100u, 0, 3},
  {205100u, 3, 19},
  {226900u, 0, 3},
  {233900u, 3, 3},
  {350000u, 0, 3},
  {485600u, 0, 5},
  {493600u, 3, 5},
  {514400u, 0, 5},
  {522400u, 3, 5},
  {543200u, 0, 5},
  {551200u, 3, 13},
  {572000u, 0, 5},
  {580000u, 3, 13},
  {600800u, 0, 5},
  {608800u, 3, 13},
  {629600u, 0, 5},
  {637600u, 3, 13},
  {658400u, 0, 5},
  {666400u, 3, 13},
  {687200u, 0, 5},
  {695200u, 3, 13},
  {716000u, 0, 5},
  {724000u, 3, 13},
  {744800u, 0, 5},
  {752800u, 3, 21},
  {773600u, 0, 5},
  {781600u, 3, 21},
  {802400u, 0, 5},
  {810400u, 3, 21},
  {831200u, 0, 5},
  {839200u, 3, 21},
  {860000u, 0, 5},
  {868000u, 3, 21},
  {4294967295u, 0, 7},
};

// E4000 LNA filter chain -> reg 0x10
struct E4000LNAFilt { uint32_t khz_max; uint8_t reg10; };
static const E4000LNAFilt kE4000LNAFilt[28] = {
  {370000u, 0},
  {392500u, 1},
  {437500u, 3},
  {462500u, 4},
  {490000u, 5},
  {522500u, 6},
  {557500u, 7},
  {595000u, 8},
  {642500u, 9},
  {695000u, 10},
  {740000u, 11},
  {800000u, 12},
  {930000u, 14},
  {1000000u, 15},
  {1310000u, 0},
  {1340000u, 1},
  {1385000u, 2},
  {1427500u, 3},
  {1452500u, 4},
  {1475000u, 5},
  {1510000u, 6},
  {1545000u, 7},
  {1615000u, 9},
  {1670000u, 11},
  {1690000u, 12},
  {1710000u, 13},
  {1735000u, 14},
  {4294967295u, 15},
};

// E4000 IF filter chain (IF_BW = bandwidth/2 kHz) -> regs 0x11, 0x12
struct E4000IFFilt { uint32_t ifbw_khz_max; uint8_t reg11; uint8_t reg12; };
static const E4000IFFilt kE4000IFFilt[33] = {
  {2150u, 253, 31},
  {2200u, 253, 30},
  {2240u, 252, 29},
  {2280u, 252, 28},
  {2300u, 252, 27},
  {2400u, 252, 26},
  {2450u, 252, 25},
  {2500u, 252, 24},
  {2550u, 252, 23},
  {2600u, 252, 22},
  {2700u, 252, 21},
  {2750u, 252, 20},
  {2800u, 252, 19},
  {2900u, 251, 18},
  {2950u, 251, 17},
  {3000u, 251, 16},
  {3100u, 251, 15},
  {3200u, 250, 14},
  {3300u, 250, 13},
  {3400u, 249, 12},
  {3600u, 249, 11},
  {3700u, 249, 10},
  {3800u, 248, 9},
  {3900u, 248, 8},
  {4100u, 248, 7},
  {4300u, 247, 6},
  {4400u, 247, 5},
  {4600u, 247, 4},
  {4800u, 246, 3},
  {5000u, 246, 2},
  {5300u, 245, 1},
  {5500u, 245, 0},
  {4294967295u, 0, 32},
};

// E4000 LNA gain map: (tenth-dB, reg 0x14 low-nibble value)
struct E4000Gain { int tenth_db; uint8_t reg14; };
static const E4000Gain kE4000Gains[14] = {
  {-50, 2},
  {-25, 3},
  {0, 4},
  {25, 5},
  {50, 6},
  {75, 7},
  {100, 8},
  {125, 9},
  {150, 10},
  {175, 11},
  {200, 12},
  {225, 13},
  {250, 14},
  {300, 15},
};

} }  // namespace rtl::tables
