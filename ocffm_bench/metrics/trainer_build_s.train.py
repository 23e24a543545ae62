"""Seconds of the ``Trainer(...)`` constructor (the device data and the
static plans of ``make_device_data``), by the host clock."""


def read(run):
    return run.get("build_s")
