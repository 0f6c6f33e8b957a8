"""pipeline: device milliseconds of host-to-device and device-to-host
copies per plane the window's tiles destriped, from the device trace."""


def read(run):
    planes = run.window.get("planes_run")
    copies = [e - s for s, e, name, kind in run.trace.device
              if kind == "memcpy" and ("HtoD" in name or "DtoH" in name)]
    if not planes or not copies:
        return None
    return sum(copies) / 1e6 / planes
