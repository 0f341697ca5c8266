"""UNet calls an edited frame, both stages: the ``unet_calls`` counters of
``Inverter`` and ``Generator`` (calls that ran, full or shallow)."""


def read(rec):
    if not rec["unet_calls"]:
        return None
    return rec["unet_calls"] * rec["edits"] / rec["frames"]
