"""String helpers (reference ``src/utils/str_conversion.py``); a copy of
``mba_tpu/utils/str_conversion.py``."""
from __future__ import annotations


def str_to_float(value: str, is_ger_format: bool = True) -> float:
    """Parse German-format numbers ('1.234,56 kg' → 1234.56), dropping
    units/letters; empty after stripping → 0.0.

    Parity: reference str_conversion.py:1-13.
    """
    s = str(value)
    if is_ger_format:
        s = s.replace(".", "").replace(",", ".")
    s = "".join(ch for ch in s if not ch.isalpha())
    s = s.strip()
    return 0.0 if s == "" else float(s)


def enter_line_breaks(text: str, max_line_length: int = 60,
                      break_char: str = "\n") -> str:
    """Insert line breaks at word boundaries so no line exceeds the limit.

    Parity: reference str_conversion.py:16-45.
    """
    words = text.split(" ")
    lines: list[str] = []
    current = ""
    for word in words:
        candidate = word if not current else current + " " + word
        if len(candidate) > max_line_length and current:
            lines.append(current)
            current = word
        else:
            current = candidate
    if current:
        lines.append(current)
    return break_char.join(lines)
