"""Configuration and algorithm constants for the PyTorch/CUDA port.

A copy of speedy_tpu/config.py, without the JAX package: importing
speedy_tpu pulls JAX in (speedy_tpu/__init__.py), and the port must run
where JAX is absent. tests/test_torch_config.py holds every property equal
to the original. Every constant here is traceable to the reference C
implementation (speedy.c / speedy.h). This module is the port's single
source of truth for the algorithm's magic numbers.

Reference citations:
  - frame rate 100 Hz:                       speedy.c:90
  - minimum speed 0.01:                      speedy.c:92
  - hysteresis future/past (MATCH_MATLAB):   speedy.h:136-146
  - window = 1.5*fs/100, fft = 2*window:     speedy.c:213-215
  - Hamming window 0.54 - 0.46 cos:          speedy.c:256-258
  - Matlab-derived normalization means:      speedy.c:259-267
  - preemphasis coefficient 0.97:            speedy.c:416-425
  - eps = 2.2204e-16:                        speedy.c:641,712
  - low-energy threshold 0.04*max_hyst:      speedy.c:682
  - speech-changes clamp 4*mean_rsd:         speedy.c:727-728
  - tension constants a,b,M_E,M_S:           speedy.c:754
  - LPF time constant = kFrameRateHz frames: speedy.c:287-292
"""

from __future__ import annotations

import dataclasses
import math


FRAME_RATE_HZ = 100.0
MIN_SPEED = 0.01
PREEMPHASIS_COEF = 0.97
EPS = 2.2204e-16

# Matlab-derived normalization constants (speedy.c:259-267).
MEAN_SPECTROGRAM_ENERGY = 2.14204
MEAN_EMPHASIS_WEIGHTED_LOCAL_DIFFERENCE = 123.837
MEAN_EMPHASIS_WEIGHTED_LPF = 123.979
MEAN_RELATIVE_SPECTRAL_DIFFERENCE = 0.971975
MAX_ENERGY_HYSTERESIS = 1.41421

# Tension combination constants (speedy.c:754).
TENSION_A = 0.5
TENSION_B = 0.25
TENSION_M_E = 0.7
TENSION_M_S = 1.0

# Feature vector layout (speedy.c:106-124). kFeatureValueCount = 15.
FEATURE_COUNT = 15
F_SPECTROGRAM_ENERGY = 0
F_ENERGY_LP = 1
F_ENERGY_LOCAL = 2
F_ENERGY_COMPRESSED = 3
F_ENERGY_HYSTERESIS = 4
F_LOW_ENERGY_FRAME = 5
F_LOCAL_SPECTRAL_DIFFERENCE = 6
F_EMPHASIS_WEIGHTED_LOCAL_DIFFERENCE = 7
F_EMPHASIS_WEIGHTED_LPF = 8
F_RELATIVE_SPECTRAL_DIFFERENCE = 9
F_SPEECH_CHANGES = 10
F_AUDIO_TENSION = 11
F_TIME_ENERGY = 12
F_TIME_SPECTRAL = 13
F_LOW_ENERGY_THRESHOLD = 14

# WSOLA pitch-search range, matching the libsonic contract the reference's
# shim drives (sonic.h: SONIC_MIN_PITCH=65, SONIC_MAX_PITCH=400).
WSOLA_MIN_PITCH_HZ = 65
WSOLA_MAX_PITCH_HZ = 400


@dataclasses.dataclass(frozen=True)
class SpeedyConfig:
    """Static, shape-determining configuration for one analysis stream.

    All fields are Python ints/floats/bools, so a config is hashable and
    every shape it determines is a plain Python int.
    """

    sample_rate: int
    match_matlab: bool = True

    @property
    def window_size(self) -> int:
        # speedy.c:213: (int)(1.5*sample_rate/kFrameRateHz)
        return int(1.5 * self.sample_rate / FRAME_RATE_HZ)

    @property
    def fft_size(self) -> int:
        # speedy.c:214
        return 2 * self.window_size

    @property
    def half_fft(self) -> int:
        """Number of spectrogram bins consumed by the algorithm (fft/2)."""
        return self.fft_size // 2

    @property
    def frame_step_float(self) -> float:
        """Float frame step used by the direct speedyAddData test harnesses
        (speedy_test.cc:466,547: kSampleRate / 100.0)."""
        return self.sample_rate / FRAME_RATE_HZ

    @property
    def frame_step_int(self) -> int:
        """Integer frame step used by the sonic2 shim
        (speedy.c:335-338: sample_rate / kFrameRateHz with int truncation)."""
        return int(self.sample_rate // int(FRAME_RATE_HZ))

    @property
    def hysteresis_future(self) -> int:
        # speedy.h:136-146 (Matlab swapped past/future; tests pin Matlab mode).
        return 8 if self.match_matlab else 12

    @property
    def hysteresis_past(self) -> int:
        return 12 if self.match_matlab else 8

    @property
    def lpf_alpha(self) -> float:
        # DesignFirstOrderLowpassFilter with tau = kFrameRateHz frames
        # (speedy.c:63-71,287-292): alpha = exp(-1/tau).
        return math.exp(-1.0 / FRAME_RATE_HZ)

    @property
    def low_energy_threshold(self) -> float:
        # speedy.c:682
        return 0.04 * MAX_ENERGY_HYSTERESIS

    @property
    def speech_changes_clamp(self) -> float:
        # speedy.c:727-728
        return 4.0 * MEAN_RELATIVE_SPECTRAL_DIFFERENCE

    @property
    def wsola_min_period(self) -> int:
        return int(self.sample_rate // WSOLA_MAX_PITCH_HZ)

    @property
    def wsola_max_period(self) -> int:
        return int(self.sample_rate // WSOLA_MIN_PITCH_HZ)

    def bin_to_freq(self, bin_number: int) -> float:
        """Center frequency (Hz) of a spectrogram bin
        (speedyBinToFreq, speedy.h:94, speedy.c:345-348)."""
        return bin_number * (self.sample_rate / float(self.fft_size))

    def freq_to_bin(self, freq: float) -> int:
        """Spectrogram bin nearest a frequency in Hz
        (speedyFreqToBin, speedy.h:95, speedy.c:350-353)."""
        return int(round(freq * self.fft_size / float(self.sample_rate)))

    def num_frames(self, num_samples: int, integer_step: bool = False) -> int:
        """Frame count for an utterance of `num_samples` samples.

        Float-step mode matches the reference test harness
        (speedy_test.cc:552: (size - window)/step + 1 truncated to int);
        integer-step mode matches the sonic2 shim's 1/frameRate buffers.
        """
        if num_samples < self.window_size:
            return 0
        if integer_step:
            return (num_samples - self.window_size) // self.frame_step_int + 1
        return int((num_samples - self.window_size) / self.frame_step_float + 1)

    def num_tension_frames(self, num_frames: int) -> int:
        """Tension frames available after `num_frames` AddData calls
        (speedy.c:755: at_time + future <= current_time)."""
        return max(0, num_frames - self.hysteresis_future)
