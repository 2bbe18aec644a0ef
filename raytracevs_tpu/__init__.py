"""raytracevs_tpu: a ray-tracing framework in JAX.

Brand-new implementation with the capabilities of RayTraceVS (a Windows
DX12/DXR node-graph ray tracer): .rtvs node-graph scenes, a wavefront path
tracer with PBR/BSDF materials, soft shadows, photon-mapped caustics,
denoising and tone-mapped composite — written as data-parallel JAX
programs that XLA compiles for the accelerator.
"""
from .runtime.engine import Engine, render_rtvs
from .scene.data import (
    BoxData, CameraData, LightData, LightType, MaterialData, MeshObjectData,
    PlaneData, RenderSettings, SceneData, SphereData,
)
from .scene.evaluator import evaluate_scene
from .scene.flatten import FlatScene, RenderConfig, flatten_scene, make_config
from .scene.graph import Node, NodeConnection, NodeGraph, NodeSocket, SocketType
from .scene.rtvs import load_graph, save_graph
from .scene.sanitize import sanitize_scene

__version__ = "0.1.0"
