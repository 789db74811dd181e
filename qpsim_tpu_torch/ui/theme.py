"""Retro desktop theme for the Tkinter app (reference qpsim/ui/theme.py)."""

from __future__ import annotations

PALETTE = {
    "face": "#d4d0c8",
    "face_dark": "#808080",
    "face_light": "#ffffff",
    "accent": "#0a246a",
    "accent_text": "#ffffff",
    "text": "#000000",
    "field": "#ffffff",
    "warn": "#7a0000",
}

FONT_BASE = ("Tahoma", 9)
FONT_TITLE = ("Tahoma", 9, "bold")
FONT_BIG = ("Tahoma", 14, "bold")


def apply_theme(root) -> None:
    """Apply the palette/font defaults to a Tk root window."""
    root.configure(bg=PALETTE["face"])
    defaults = {
        "*Background": PALETTE["face"],
        "*Foreground": PALETTE["text"],
        "*Font": "{Tahoma} 9",
        "*Entry.Background": PALETTE["field"],
        "*Listbox.Background": PALETTE["field"],
        "*Text.Background": PALETTE["field"],
        "*Button.activeBackground": PALETTE["face_light"],
    }
    for pattern, value in defaults.items():
        try:
            root.option_add(pattern, value)
        except Exception:
            pass
