"""Navigation audio feedback port + engine + mock (counterpart of the JAX
package's utils/audio.py; host-only).

Parity: reference IAudioFeedback (include/interfaces/IAudioFeedback.hpp:
speak/playBeep/playCriticalAlert with priorities) and the H16
NavigationAudioEngine design (SURVEY.md row 27): detections (+ depth
estimate) -> direction (left/center/right by bbox x) and priority
(CRITICAL < 1 m ... LOW) with per-class cooldowns
(0/500/800/2000 ms). Real TTS/PulseAudio backends are host-specific;
the engine emits structured audio events to any sink — a console sink
and a recording mock are provided (the mock mirrors H16's
MockAudioFeedback for assertions). The engine takes the port's
Detections (torch tensors, on the card or the CPU) through one host copy
a call, or host arrays.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Protocol, runtime_checkable

import numpy as np


class Priority(enum.IntEnum):
    LOW = 0
    MEDIUM = 1
    HIGH = 2
    CRITICAL = 3


# per-priority cooldowns, ms (parity: H16 0/500/800/2000 design values,
# CRITICAL interrupts immediately)
COOLDOWN_MS = {
    Priority.CRITICAL: 0,
    Priority.HIGH: 500,
    Priority.MEDIUM: 800,
    Priority.LOW: 2000,
}

COCO_NAMES_ES = {  # the reference speaks Spanish class names (H16 doc)
    0: "persona", 1: "bicicleta", 2: "coche", 3: "moto", 5: "autobus",
    6: "tren", 7: "camion", 14: "pajaro", 15: "gato", 16: "perro",
}
COCO_NAMES_EN = {
    0: "person", 1: "bicycle", 2: "car", 3: "motorcycle", 5: "bus",
    6: "train", 7: "truck", 14: "bird", 15: "cat", 16: "dog",
}


class Direction(enum.Enum):
    LEFT = "left"
    CENTER = "center"
    RIGHT = "right"


@dataclass
class AudioEvent:
    timestamp: float
    kind: str            # "speech" | "beep" | "critical"
    message: str
    direction: Direction
    priority: Priority
    pan: float           # -1 (left) .. +1 (right) stereo position


@runtime_checkable
class AudioFeedback(Protocol):
    """Port (parity: IAudioFeedback)."""

    def speak(self, message: str, priority: Priority = Priority.MEDIUM) -> None: ...
    def play_beep(self, pan: float, priority: Priority = Priority.MEDIUM) -> None: ...
    def play_critical_alert(self, message: str) -> None: ...


class ConsoleAudioFeedback:
    """Prints events (the degrade-gracefully default on headless hosts)."""

    def speak(self, message, priority=Priority.MEDIUM):
        print(f"[audio:{priority.name}] {message}")

    def play_beep(self, pan, priority=Priority.MEDIUM):
        side = "L" if pan < -0.3 else ("R" if pan > 0.3 else "C")
        print(f"[beep:{priority.name}] {side}")

    def play_critical_alert(self, message):
        print(f"[ALERT] {message}")


class MockAudioFeedback:
    """Records every call for test assertions (parity: H16 MockAudioFeedback)."""

    def __init__(self):
        self.spoken: List[tuple] = []
        self.beeps: List[tuple] = []
        self.alerts: List[str] = []

    def speak(self, message, priority=Priority.MEDIUM):
        self.spoken.append((message, priority))

    def play_beep(self, pan, priority=Priority.MEDIUM):
        self.beeps.append((pan, priority))

    def play_critical_alert(self, message):
        self.alerts.append(message)


class EspeakAudioFeedback:
    """Real TTS + beep sink (parity: H16's espeak-ng + PulseAudio design,
    docs/milestones/H16_AUDIO_FEEDBACK.md): speech via espeak-ng/espeak,
    spatial beeps as generated stereo WAVs through paplay/aplay. All
    subprocess launches are fire-and-forget so audio never blocks the
    SLAM loop. Construct via create_audio_feedback(), which probes the
    host for the binaries and degrades to the console sink."""

    # critical alerts preempt queued speech; normal speech is serialized
    def __init__(self, tts_bin: str, play_bin: Optional[str] = None,
                 runner=None, language: str = "en"):
        import subprocess

        self._tts = tts_bin
        self._play = play_bin
        self._lang = "en" if language == "en" else "es"
        self._run = runner or (
            lambda cmd: subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL
            )
        )
        self._beep_cache: Dict[int, str] = {}

    def speak(self, message, priority=Priority.MEDIUM):
        speed = "175" if priority < Priority.HIGH else "210"
        self._run([self._tts, "-v", self._lang, "-s", speed, message])

    def play_critical_alert(self, message):
        self.speak(message, Priority.CRITICAL)

    def _beep_wav(self, pan: float, freq: int) -> str:
        """Write (and cache) a 120 ms stereo sine beep panned by `pan`."""
        import os
        import struct
        import tempfile
        import wave

        key = (round(pan, 1), freq)
        cached = self._beep_cache.get(key)
        if cached and os.path.exists(cached):
            return cached
        sr = 22050
        t = np.arange(int(0.12 * sr)) / sr
        tone = np.sin(2 * np.pi * freq * t) * np.hanning(len(t))
        left = tone * (0.5 * (1.0 - pan))
        right = tone * (0.5 * (1.0 + pan))
        pcm = np.stack([left, right], -1)
        pcm16 = (np.clip(pcm, -1, 1) * 32767).astype(np.int16)
        fd, path = tempfile.mkstemp(suffix=".wav", prefix="aria_beep_")
        os.close(fd)
        with wave.open(path, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes(struct.pack(f"<{pcm16.size}h", *pcm16.reshape(-1)))
        self._beep_cache[key] = path
        return path

    def play_beep(self, pan, priority=Priority.MEDIUM):
        if self._play is None:
            return  # TTS-only host
        freq = {Priority.CRITICAL: 1400, Priority.HIGH: 1000,
                Priority.MEDIUM: 700, Priority.LOW: 500}[priority]
        self._run([self._play, self._beep_wav(float(pan), freq)])


def create_audio_feedback(language: str = "en",
                          prefer_real: bool = True) -> AudioFeedback:
    """Probe the host for espeak-ng/espeak + paplay/aplay and return the
    best available sink (real TTS if present, console otherwise). The
    degrade-gracefully default mirrors the reference's engine-load
    fallback style (src/main.cpp:93-98)."""
    import shutil

    if prefer_real:
        tts = shutil.which("espeak-ng") or shutil.which("espeak")
        if tts:
            play = shutil.which("paplay") or shutil.which("aplay")
            return EspeakAudioFeedback(tts, play, language=language)
    return ConsoleAudioFeedback()


def _host(*arrays):
    """Host numpy copies of arrays that may be torch tensors: the tensors
    arrive through one copy (pipeline/slam_pipeline.fetch_many)."""
    import torch

    tensors = [a for a in arrays if isinstance(a, torch.Tensor)]
    if not tensors:
        return [np.asarray(a) for a in arrays]
    from aria_slam_tpu_torch.pipeline.slam_pipeline import fetch_many

    fetched = iter(fetch_many(tensors))
    return [next(fetched) if isinstance(a, torch.Tensor) else np.asarray(a) for a in arrays]


class NavigationAudioEngine:
    """Maps detections to spatialized audio guidance with cooldowns."""

    def __init__(self, sink: AudioFeedback, image_width: int = 640,
                 language: str = "en", clock=time.monotonic):
        self.sink = sink
        self.width = image_width
        self.names = COCO_NAMES_EN if language == "en" else COCO_NAMES_ES
        self._clock = clock
        self._last_spoken: Dict[int, float] = {}

    def _direction(self, x_center: float) -> Direction:
        frac = x_center / self.width
        if frac < 1 / 3:
            return Direction.LEFT
        if frac > 2 / 3:
            return Direction.RIGHT
        return Direction.CENTER

    @staticmethod
    def _priority(depth_m: Optional[float]) -> Priority:
        if depth_m is None:
            return Priority.MEDIUM
        if depth_m < 1.0:
            return Priority.CRITICAL
        if depth_m < 2.0:
            return Priority.HIGH
        if depth_m < 4.0:
            return Priority.MEDIUM
        return Priority.LOW

    def process(self, detections, depths=None) -> List[AudioEvent]:
        """process_detections on a Detections (core/types.py)."""
        return self.process_detections(detections.boxes, detections.classes,
                                       detections.valid, depths)

    def process_detections(self, boxes, classes, valid,
                           depths=None) -> List[AudioEvent]:
        """boxes (D,4) xyxy px, classes (D,) int, valid (D,) bool,
        depths (D,) meters or None: host arrays, or tensors, read with
        one copy to the host. Emits at most one event per class per
        cooldown window; returns the emitted events."""
        now = self._clock()
        events: List[AudioEvent] = []
        boxes, classes, valid = _host(boxes, classes, valid)
        order = np.argsort(
            [-(self._priority(depths[i] if depths is not None else None))
             for i in range(len(classes))]
        )
        for i in order:
            if not valid[i] or int(classes[i]) not in self.names:
                continue
            cid = int(classes[i])
            depth = depths[i] if depths is not None else None
            pri = self._priority(depth)
            cooldown = COOLDOWN_MS[pri] / 1000.0
            if now - self._last_spoken.get(cid, -1e9) < cooldown:
                continue
            x_c = 0.5 * (boxes[i, 0] + boxes[i, 2])
            direction = self._direction(x_c)
            pan = float(np.clip(2.0 * x_c / self.width - 1.0, -1.0, 1.0))
            name = self.names[cid]
            if depth is not None:
                msg = f"{name} {direction.value}, {depth:.0f} meter"
            else:
                msg = f"{name} {direction.value}"
            ev = AudioEvent(now, "critical" if pri == Priority.CRITICAL else "speech",
                            msg, direction, pri, pan)
            if pri == Priority.CRITICAL:
                self.sink.play_critical_alert(msg)
            else:
                self.sink.speak(msg, pri)
            self.sink.play_beep(pan, pri)
            self._last_spoken[cid] = now
            events.append(ev)
        return events
