"""HTTP adapters: payload → model-input conversion at the ingress.

Copy of ``ray_tpu/serve/http_adapters.py``. Reference analogue:
serve/http_adapters.py (json_to_ndarray,
json_to_multi_ndarray, pandas_read_json, image_to_ndarray,
starlette_request). Design difference: this proxy (http_proxy.py)
decodes the body BEFORE routing — JSON bodies arrive as Python
objects, non-JSON as str — so adapters transform that decoded payload
rather than a raw ASGI request. Compose one with a driver via
``DAGDriver.bind(routes, http_adapter=json_to_ndarray)``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def starlette_request(payload: Any) -> Any:
    """Identity — hand the decoded payload through unchanged (the
    reference's default)."""
    return payload


def json_request(payload: Any) -> Any:
    """Alias of the default for API parity."""
    return payload


def json_to_ndarray(payload: Any) -> np.ndarray:
    """{"array": [...]} or a bare list → float32 ndarray (reference:
    http_adapters.py json_to_ndarray)."""
    if isinstance(payload, dict):
        if "array" not in payload:
            raise ValueError(
                "json_to_ndarray expects {'array': [...]} "
                f"(got keys {sorted(payload)})")
        payload = payload["array"]
    return np.asarray(payload, dtype=np.float32)


def json_to_multi_ndarray(payload: Any) -> Dict[str, np.ndarray]:
    """{name: nested-list} → {name: ndarray}."""
    if not isinstance(payload, dict):
        raise ValueError("json_to_multi_ndarray expects a JSON object")
    return {k: np.asarray(v, dtype=np.float32)
            for k, v in payload.items()}


def pandas_read_json(payload: Any):
    """JSON records → pandas DataFrame (requires pandas)."""
    import pandas as pd
    if isinstance(payload, str):
        import io
        return pd.read_json(io.StringIO(payload))
    return pd.DataFrame(payload)


def image_to_ndarray(payload: Any) -> np.ndarray:
    """Base64-encoded image bytes → HWC uint8 ndarray (requires PIL;
    reference: http_adapters.py image_to_ndarray)."""
    import base64
    import io
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover - PIL not in image
        raise ImportError(
            "image_to_ndarray requires pillow, which is not installed "
            "in this environment") from e
    if isinstance(payload, dict):
        payload = payload.get("image", payload.get("data"))
    data = base64.b64decode(payload)
    return np.asarray(Image.open(io.BytesIO(data)))
