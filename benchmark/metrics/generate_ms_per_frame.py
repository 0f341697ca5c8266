"""Host milliseconds of the generation's sampling an edited frame: the
harness's span around ``Generator.sample`` (the chunked DDIM loop with
merging, without the decode), ended by a synchronize."""


def read(rec):
    s = rec["stage_s"].get("generate")
    return None if not s else 1e3 * s / rec["frames"]
