"""Designs a second: every design answered in the window over the window's
whole length."""


def read(window):
    return window["designs"] / window["seconds"] if window.get("designs") else None
