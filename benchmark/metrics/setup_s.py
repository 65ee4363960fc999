"""End-to-end: process start to the window's start."""


def read(run: dict):
    return run["setup_s"]
