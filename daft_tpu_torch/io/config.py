"""IO configuration (port of ``daft_tpu/io/config.py``).

Reference: src/common/io-config (S3Config / AzureConfig / GCSConfig /
HTTPConfig bundled into IOConfig, threaded through scans and writes), lowered
by ``filesystem_for`` onto the native clients (``s3_client.py``,
``gcs_client.py``) or pyarrow's Arrow C++ filesystems.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


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


def filesystem_for(scheme: str, io_config: Optional[IOConfig]):
    """Build a pyarrow filesystem honouring the IOConfig, or None to use
    pyarrow's default URI resolution. ``s3`` takes the native sigv4 client
    under ``use_native_client`` or ``DAFT_NATIVE_S3=1`` and Arrow's
    ``S3FileSystem`` otherwise; ``gs`` / ``gcs`` take the native client by
    default (``use_native_client=False`` or ``DAFT_NATIVE_GCS=0`` opt out to
    Arrow's ``GcsFileSystem``); ``az`` / ``abfs`` / ``abfss`` take Arrow's
    ``AzureFileSystem``."""
    import pyarrow.fs as pafs

    if io_config is None:
        return None
    if scheme == "s3":
        from daft_tpu_torch.config import daft_env

        cfg = io_config.s3
        if cfg.use_native_client or daft_env("DAFT_NATIVE_S3") == "1":
            from daft_tpu_torch.io.s3_client import S3Client, S3FileSystemHandler

            return pafs.PyFileSystem(S3FileSystemHandler(S3Client(cfg)))
        kwargs = {}
        if cfg.region_name:
            kwargs["region"] = cfg.region_name
        if cfg.endpoint_url:
            kwargs["endpoint_override"] = cfg.endpoint_url
        if cfg.anonymous:
            kwargs["anonymous"] = True
        elif cfg.key_id:
            kwargs["access_key"] = cfg.key_id
            kwargs["secret_key"] = cfg.access_key
            if cfg.session_token:
                kwargs["session_token"] = cfg.session_token
        kwargs["connect_timeout"] = cfg.connect_timeout_ms / 1000.0
        return pafs.S3FileSystem(**kwargs)
    if scheme in ("gs", "gcs"):
        import os

        from daft_tpu_torch.config import daft_env

        cfg = io_config.gcs
        if cfg.use_native_client and daft_env("DAFT_NATIVE_GCS") != "0":
            from daft_tpu_torch.io.gcs_client import GCSClient, GcsFileSystemHandler

            return pafs.PyFileSystem(GcsFileSystemHandler(GCSClient(cfg)))
        kwargs = {}
        if cfg.anonymous:
            kwargs["anonymous"] = True
        if cfg.project_id:
            kwargs["project_id"] = cfg.project_id
        if cfg.credentials_path:
            # Arrow's GCS filesystem reads ADC from the environment: this
            # writes the child SDK's convention, as the JAX package does.
            os.environ.setdefault("GOOGLE_APPLICATION_CREDENTIALS", cfg.credentials_path)
        return pafs.GcsFileSystem(**kwargs)
    if scheme in ("az", "abfs", "abfss"):
        cfg = io_config.azure
        if not hasattr(pafs, "AzureFileSystem"):
            from daft_tpu_torch.errors import DaftIOError

            raise DaftIOError("This pyarrow build has no AzureFileSystem")
        kwargs = {}
        if cfg.storage_account:
            kwargs["account_name"] = cfg.storage_account
        if cfg.access_key:
            kwargs["account_key"] = cfg.access_key
        return pafs.AzureFileSystem(**kwargs)
    return None


# --------------------------------------------------------------------- #
# Process-wide storage options (reference: DataFrame.set_storage_option) #
# --------------------------------------------------------------------- #
_STORAGE_OPTIONS: dict = {}


def set_storage_option(key: str, value: str) -> None:
    _STORAGE_OPTIONS[str(key)] = str(value)


def get_storage_options() -> dict:
    return dict(_STORAGE_OPTIONS)
