"""Image-dataset ingestion (port of ``dss_ml_at_scale_tpu/ingest``)."""

from .imagenet import (
    copy_parallel,
    extract_object,
    ingest_image_dataset,
    object_id_from_path,
    scan_binary_files,
    xml_annotation_to_json,
)

__all__ = [
    "copy_parallel",
    "extract_object",
    "ingest_image_dataset",
    "object_id_from_path",
    "scan_binary_files",
    "xml_annotation_to_json",
]
