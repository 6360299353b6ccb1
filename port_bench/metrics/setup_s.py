"""setup_s: from the start of the process to the window's start: data,
segment builds, loading, staging and warm-up, compilation included."""


def read(obs):
    return obs["setup_s"]
