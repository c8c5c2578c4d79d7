"""Member-epochs a second: every member-epoch the window completed over the
window's whole length."""


def read(window):
    return window["member_epochs"] / window["seconds"] if window.get("member_epochs") else None
