"""
AIND provenance metadata: ``image_destriping_{channel}_processing.json``.

The reference builds this with aind-data-schema pydantic models
(run_capsule.py:67-175: Processing / PipelineProcess / DataProcess with
ProcessName.IMAGE_DESTRIPING + IMAGE_FLAT_FIELD_CORRECTION). That package is
not in this runtime, so the same JSON document structure (schema v1.x
"processing" layout) is emitted directly.
"""

from __future__ import annotations

import json
import os
from datetime import datetime, timezone
 

CODE_URL = "https://github.com/AllenNeuralDynamics/aind-smartspim-destripe"
PIPELINE_URL = "https://github.com/AllenNeuralDynamics/aind-smartspim-pipeline"


def _iso(t) -> str:
    if isinstance(t, datetime):
        return t.isoformat()
    return datetime.fromtimestamp(float(t), tz=timezone.utc).isoformat()


def _data_process(
    name: str,
    software_version: str,
    start_time,
    end_time,
    input_location: str,
    output_location: str,
    parameters: dict,
    notes: str,
) -> dict:
    return {
        "name": name,
        "software_version": software_version,
        "start_date_time": _iso(start_time),
        "end_date_time": _iso(end_time),
        "input_location": str(input_location),
        "output_location": str(output_location),
        "code_version": software_version,
        "code_url": CODE_URL,
        "parameters": parameters,
        "outputs": {},
        "notes": notes,
    }


def generate_data_processing(
    channel_name: str,
    destripe_version: str,
    destripe_config: dict,
    start_time,
    end_time,
    output_directory: str,
    processor_full_name: str = "Camilo Laiton",
):
    """Write the per-channel processing JSON (reference run_capsule.py:67-175
    behavior, including popping input/output paths out of the recorded
    parameter dict)."""
    output_directory = os.path.abspath(output_directory)
    if not os.path.exists(output_directory):
        raise FileNotFoundError(
            f"Please, check that this folder exists {output_directory}"
        )

    destripe_config = dict(destripe_config)
    input_path = destripe_config.pop("input_path", "")
    output_path = destripe_config.pop("output_path", "")

    note_shadow_correction = "Applying the flats that come from the microscope"
    if destripe_config.get("retrospective"):
        note_shadow_correction = (
            "The flats were computed from the data with basicpy, these were "
            "applied with the destriping algorithm and with the current dark "
            "from the microscope."
        )

    serializable = json.loads(json.dumps(destripe_config, default=str))

    processing = {
        "describedBy": (
            "https://raw.githubusercontent.com/AllenNeuralDynamics/"
            "aind-data-schema/main/src/aind_data_schema/core/processing.py"
        ),
        "schema_version": "1.0.0",
        "processing_pipeline": {
            "data_processes": [
                _data_process(
                    "Image destriping",
                    destripe_version,
                    start_time,
                    end_time,
                    input_path,
                    output_path,
                    serializable,
                    f"Destriping for channel {channel_name} in zarr format",
                ),
                _data_process(
                    "Image flat-field correction",
                    destripe_version,
                    start_time,
                    end_time,
                    input_path,
                    output_path,
                    {},
                    note_shadow_correction,
                ),
            ],
            "processor_full_name": processor_full_name,
            "pipeline_url": PIPELINE_URL,
            "pipeline_version": "3.0.0",
        },
        "notes": (
            "This processing only contains metadata about destriping and "
            "needs to be compiled with other steps at the end"
        ),
    }

    path = f"{output_directory}/image_destriping_{channel_name}_processing.json"
    with open(path, "w") as f:
        json.dump(processing, f, indent=3)
    return path
