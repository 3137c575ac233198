"""IO configuration (port of ``daft_tpu/io/config.py``).

Reference: src/common/io-config (S3Config / AzureConfig / GCSConfig /
HTTPConfig bundled into IOConfig, threaded through scans and writes). The
config dataclasses are plain data here; the port serves local paths only, so
``filesystem_for`` raises for every object-store scheme: the clients
(``s3_client.py``, ``gcs_client.py``, ``http_source.py``) are ROADMAP A.8.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from daft_tpu_torch.errors import DaftValueError


@dataclass(frozen=True)
class S3Config:
    region_name: Optional[str] = None
    endpoint_url: Optional[str] = None
    key_id: Optional[str] = None
    access_key: Optional[str] = None
    session_token: Optional[str] = None
    anonymous: bool = False
    verify_ssl: bool = True
    connect_timeout_ms: int = 30_000
    num_tries: int = 3
    use_native_client: bool = False


@dataclass(frozen=True)
class GCSConfig:
    project_id: Optional[str] = None
    credentials_path: Optional[str] = None
    anonymous: bool = False
    token: Optional[str] = None
    endpoint_url: Optional[str] = None
    num_tries: int = 3
    use_native_client: bool = True


@dataclass(frozen=True)
class AzureConfig:
    storage_account: Optional[str] = None
    access_key: Optional[str] = None
    anonymous: bool = False


@dataclass(frozen=True)
class HTTPConfig:
    user_agent: str = "daft_tpu/0.1"
    bearer_token: Optional[str] = None


@dataclass(frozen=True)
class S3Credentials:
    """Static S3 credential bundle (reference: common/io-config
    S3Credentials)."""

    key_id: str = ""
    access_key: str = ""
    session_token: Optional[str] = None
    expiry: Optional[object] = None


@dataclass(frozen=True)
class CosConfig:
    """Tencent COS (S3-compatible; reference: common/io-config CosConfig)."""

    region_name: Optional[str] = None
    endpoint_url: Optional[str] = None
    key_id: Optional[str] = None
    access_key: Optional[str] = None
    anonymous: bool = False


@dataclass(frozen=True)
class TosConfig:
    """ByteDance TOS (S3-compatible; reference: common/io-config TosConfig)."""

    region_name: Optional[str] = None
    endpoint_url: Optional[str] = None
    key_id: Optional[str] = None
    access_key: Optional[str] = None
    anonymous: bool = False


@dataclass(frozen=True)
class GooseFSConfig:
    """GooseFS (S3-compatible cache layer; reference: GooseFSConfig)."""

    endpoint_url: Optional[str] = None
    key_id: Optional[str] = None
    access_key: Optional[str] = None


@dataclass(frozen=True)
class GravitinoConfig:
    """Apache Gravitino catalog service (reference: GravitinoConfig)."""

    uri: Optional[str] = None
    metalake: Optional[str] = None
    auth_token: Optional[str] = None


@dataclass(frozen=True)
class UnityConfig:
    """Databricks Unity Catalog (reference: UnityConfig)."""

    endpoint: Optional[str] = None
    token: Optional[str] = None


@dataclass(frozen=True)
class HuggingFaceConfig:
    """HuggingFace Hub datasets access (reference: HuggingFaceConfig)."""

    token: Optional[str] = None
    anonymous: bool = False
    use_content_defined_chunking: bool = False


@dataclass(frozen=True)
class IOConfig:
    s3: S3Config = field(default_factory=S3Config)
    gcs: GCSConfig = field(default_factory=GCSConfig)
    azure: AzureConfig = field(default_factory=AzureConfig)
    http: HTTPConfig = field(default_factory=HTTPConfig)
    cos: CosConfig = field(default_factory=CosConfig)
    tos: TosConfig = field(default_factory=TosConfig)
    goosefs: GooseFSConfig = field(default_factory=GooseFSConfig)
    gravitino: GravitinoConfig = field(default_factory=GravitinoConfig)
    unity: UnityConfig = field(default_factory=UnityConfig)
    hf: HuggingFaceConfig = field(default_factory=HuggingFaceConfig)


def remote_scheme_error(path: str) -> DaftValueError:
    scheme = path.split("://", 1)[0]
    return DaftValueError(
        f"{path!r}: the {scheme}:// scheme is not ported; the port reads and "
        "writes local paths and file:// URLs only (object stores and HTTP are "
        "ROADMAP A.8)")


def filesystem_for(scheme: str, io_config: Optional[IOConfig]):
    """The filesystem for a URI scheme: the local one for ``file``; every
    other scheme raises (the object-store clients are ROADMAP A.8)."""
    if scheme == "file":
        import pyarrow.fs as pafs

        return pafs.LocalFileSystem()
    raise remote_scheme_error(f"{scheme}://")

