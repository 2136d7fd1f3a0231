"""Point-cloud utilities: plane removal, clustering, filters.

The port's copy of `perception_tpu/utils/cloud_utils.py`: NumPy / SciPy
host code, as in the JAX package, re-implementing the reference's PCL helper
layer (perception_utils/src/perception_utils.cpp: GetRemovedPlane /
SegmentPlane, DoEuclideanClustering, DownsamplePointCloud, passthrough and
outlier filters) for table-top preprocessing upstream of a /localize
request. One difference: `inpaint_depth_image` has no OpenCV path (the
machines the port runs on have no `cv2`); it always runs the JAX package's
fallback, an iterative neighbour-mean diffusion.
"""

from __future__ import annotations

import numpy as np


def fit_plane_ransac(
    points: np.ndarray,
    distance_threshold: float = 0.01,
    max_iterations: int = 200,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """RANSAC plane fit -> (coefficients [4] with |n|=1, inlier mask).

    Mirrors pcl::SACSegmentation with SACMODEL_PLANE (perception_utils.cpp
    SegmentPlane).
    """
    rng = rng or np.random.default_rng(0)
    pts = np.asarray(points, dtype=np.float64)
    n = len(pts)
    if n < 3:
        return np.array([0, 0, 1, 0.0]), np.zeros(n, bool)
    best_mask = np.zeros(n, bool)
    best_coeffs = np.array([0, 0, 1, 0.0])
    for _ in range(max_iterations):
        idx = rng.choice(n, 3, replace=False)
        p0, p1, p2 = pts[idx]
        normal = np.cross(p1 - p0, p2 - p0)
        norm = np.linalg.norm(normal)
        if norm < 1e-12:
            continue
        normal /= norm
        d = -normal @ p0
        dist = np.abs(pts @ normal + d)
        mask = dist < distance_threshold
        if mask.sum() > best_mask.sum():
            best_mask = mask
            best_coeffs = np.array([*normal, d])
    # Refine with least squares on inliers.
    if best_mask.sum() >= 3:
        inl = pts[best_mask]
        centroid = inl.mean(axis=0)
        _, _, vt = np.linalg.svd(inl - centroid, full_matrices=False)
        normal = vt[2]
        d = -normal @ centroid
        dist = np.abs(pts @ normal + d)
        best_mask = dist < distance_threshold
        best_coeffs = np.array([*normal, d])
    return best_coeffs, best_mask


def remove_plane(points: np.ndarray, distance_threshold: float = 0.01,
                 **kwargs) -> tuple[np.ndarray, np.ndarray]:
    """Remove the dominant plane -> (remaining points, plane coefficients)
    (perception_utils RemoveGroundPlane / GetRemovedPlane)."""
    coeffs, mask = fit_plane_ransac(points, distance_threshold, **kwargs)
    return np.asarray(points)[~mask], coeffs


def euclidean_clusters(
    points: np.ndarray,
    tolerance: float = 0.02,
    min_size: int = 10,
    max_size: int = 10**9,
) -> list[np.ndarray]:
    """Connected components under a distance tolerance -> index arrays,
    largest first (pcl EuclideanClusterExtraction,
    perception_utils DoEuclideanClustering)."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points)
    n = len(pts)
    if n == 0:
        return []
    tree = cKDTree(pts)
    pairs = tree.query_pairs(tolerance, output_type="ndarray")
    # Union-find.
    parent = np.arange(n)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for a, b in pairs:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra
    roots = np.array([find(i) for i in range(n)])
    clusters = []
    for r in np.unique(roots):
        idx = np.nonzero(roots == r)[0]
        if min_size <= len(idx) <= max_size:
            clusters.append(idx)
    clusters.sort(key=len, reverse=True)
    return clusters


def voxel_downsample(points: np.ndarray, leaf_size: float,
                     attributes: np.ndarray | None = None):
    """Voxel-grid downsampling to per-cell centroids (pcl VoxelGrid,
    perception_utils DownsamplePointCloud)."""
    pts = np.asarray(points, dtype=np.float64)
    if len(pts) == 0:
        return (pts, attributes) if attributes is not None else pts
    keys = np.floor(pts / leaf_size).astype(np.int64)
    _, inverse = np.unique(keys, axis=0, return_inverse=True)
    k = inverse.max() + 1
    counts = np.bincount(inverse, minlength=k).astype(np.float64)
    out = np.stack([np.bincount(inverse, weights=pts[:, i], minlength=k)
                    for i in range(pts.shape[1])], axis=1) / counts[:, None]
    if attributes is not None:
        attr = np.asarray(attributes, dtype=np.float64)
        aout = np.stack(
            [np.bincount(inverse, weights=attr[:, i], minlength=k)
             for i in range(attr.shape[1])], axis=1) / counts[:, None]
        return out, aout
    return out


def passthrough_filter(points: np.ndarray, axis: int,
                       lo: float, hi: float) -> np.ndarray:
    """Keep points with lo <= p[axis] <= hi (pcl PassThrough)."""
    pts = np.asarray(points)
    mask = (pts[:, axis] >= lo) & (pts[:, axis] <= hi)
    return pts[mask]


def statistical_outlier_removal(points: np.ndarray, k: int = 20,
                                std_ratio: float = 2.0) -> np.ndarray:
    """Drop points whose mean k-NN distance exceeds mean + std_ratio*std
    (pcl StatisticalOutlierRemoval)."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points)
    if len(pts) <= k:
        return pts
    tree = cKDTree(pts)
    dists, _ = tree.query(pts, k=k + 1)
    mean_d = dists[:, 1:].mean(axis=1)
    thresh = mean_d.mean() + std_ratio * mean_d.std()
    return pts[mean_d <= thresh]


def organized_cloud_from_depth(depth: np.ndarray, fx: float, fy: float,
                               cx: float, cy: float,
                               depth_factor: float = 1000.0) -> np.ndarray:
    """Depth image -> [H, W, 3] organised cloud (invalid -> nan), mirroring
    kinect-style conversions in utils/utils.cpp."""
    h, w = depth.shape
    ys, xs = np.mgrid[0:h, 0:w]
    z = depth.astype(np.float64) / depth_factor
    with np.errstate(invalid="ignore"):
        x = (xs - cx) / fx * z
        y = (ys - cy) / fy * z
    cloud = np.stack([x, y, z], axis=-1)
    cloud[depth <= 0] = np.nan
    return cloud


def inpaint_depth_image(
    organized_cloud: np.ndarray,
    mask: np.ndarray,
    max_range: float,
    inpaint_radius: int = 5,
    resize_scale: float = 0.1,
) -> np.ndarray:
    """Fill invalid depth pixels by neighbour-mean diffusion.

    After perception_utils::InpaintDepthImage (perception_utils.cpp:
    952-1046), which runs OpenCV's Navier-Stokes inpainting on a
    `resize_scale`-downscaled 8-bit image: here up to 64 rounds grow the
    known region into the requested pixels, each new pixel the mean of its
    known 4-neighbours (the same fixed point as the Navier-Stokes solver
    for smooth regions; `inpaint_radius` and `resize_scale` are kept for
    the signature and not read; nor is `max_range`). Only pixels that are BOTH requested
    (mask > 0) AND invalid in the input get the filled value; everything
    else keeps its original (double) depth. Returns the smoothed [H, W]
    float64 depth image (m).

    organized_cloud: [H, W, 3] camera-frame metres with nan for invalid
    (organized_cloud_from_depth); mask: [H, W] >0 where inpainting is wanted.
    """
    z = np.asarray(organized_cloud[..., 2], np.float64)
    invalid = ~np.isfinite(z) | (z <= 0)
    inpaint_mask = ((np.asarray(mask) > 0) & invalid).astype(np.uint8)
    smoothed = np.where(invalid, 0.0, z)

    if not inpaint_mask.any():
        return smoothed
    fill_depth = np.where(invalid, 0.0, z)
    known = ~invalid
    for _ in range(64):
        if (known | (inpaint_mask == 0)).all():
            break
        padded = np.pad(fill_depth, 1)
        kpad = np.pad(known.astype(np.float64), 1)
        acc = (padded[:-2, 1:-1] * kpad[:-2, 1:-1]
               + padded[2:, 1:-1] * kpad[2:, 1:-1]
               + padded[1:-1, :-2] * kpad[1:-1, :-2]
               + padded[1:-1, 2:] * kpad[1:-1, 2:])
        cnt = (kpad[:-2, 1:-1] + kpad[2:, 1:-1]
               + kpad[1:-1, :-2] + kpad[1:-1, 2:])
        grow = ~known & (inpaint_mask > 0) & (cnt > 0)
        fill_depth[grow] = acc[grow] / cnt[grow]
        known = known | grow
    sel = inpaint_mask > 0
    smoothed[sel] = fill_depth[sel]
    return smoothed


def range_image_planar(
    organized_cloud: np.ndarray,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    width: int,
    height: int,
) -> np.ndarray:
    """Planar range image [height, width] from an organised (or loose) cloud.

    Equivalent of pcl::RangeImagePlanar::createFromPointCloudWithFixedSize
    as used by GetRangeImageFromCloud (perception_utils.cpp:139): each point
    projects through the pinhole model and the pixel keeps the minimum
    euclidean range. Empty pixels are -inf (PCL's unobserved convention).
    """
    pts = np.asarray(organized_cloud, np.float64).reshape(-1, 3)
    ok = np.isfinite(pts).all(axis=1) & (pts[:, 2] > 0)
    pts = pts[ok]
    rng = np.linalg.norm(pts, axis=1)
    u = np.round(pts[:, 0] / pts[:, 2] * fx + cx).astype(np.int64)
    v = np.round(pts[:, 1] / pts[:, 2] * fy + cy).astype(np.int64)
    inside = (u >= 0) & (u < width) & (v >= 0) & (v < height)
    flat = v[inside] * width + u[inside]
    out = np.full(height * width, np.inf)
    np.minimum.at(out, flat, rng[inside])
    out[~np.isfinite(out)] = -np.inf
    return out.reshape(height, width)


def euclidean_clustering_organized(
    organized_cloud: np.ndarray,
    distance_threshold: float = 0.01,
    min_cluster_size: int = 100,
) -> list[np.ndarray]:
    """Connected-component clustering on the organised pixel grid.

    Mirrors pcl::OrganizedConnectedComponentSegmentation with
    EuclideanClusterComparator (DoEuclideanClusteringOrganized,
    perception_utils.cpp:468-530): 4-neighbour pixels join one cluster when
    their euclidean distance is below the threshold. Returns a list of
    [K, 2] (row, col) pixel-index arrays, largest first — O(HW alpha) via
    union-find instead of PCL's frontier walk.
    """
    cloud = np.asarray(organized_cloud, np.float64)
    h, w, _ = cloud.shape
    valid = np.isfinite(cloud).all(axis=-1)
    idx = np.arange(h * w)
    parent = idx.copy()

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    def link(pairs_a, pairs_b):
        for a, b in zip(pairs_a, pairs_b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[max(ra, rb)] = min(ra, rb)

    thr2 = distance_threshold * distance_threshold
    # Horizontal edges.
    d = cloud[:, 1:] - cloud[:, :-1]
    near = (np.einsum("ijk,ijk->ij", d, d) <= thr2) \
        & valid[:, 1:] & valid[:, :-1]
    a = (idx.reshape(h, w)[:, :-1])[near]
    b = (idx.reshape(h, w)[:, 1:])[near]
    link(a, b)
    # Vertical edges.
    d = cloud[1:, :] - cloud[:-1, :]
    near = (np.einsum("ijk,ijk->ij", d, d) <= thr2) \
        & valid[1:, :] & valid[:-1, :]
    a = (idx.reshape(h, w)[:-1, :])[near]
    b = (idx.reshape(h, w)[1:, :])[near]
    link(a, b)

    roots = np.array([find(i) if valid.ravel()[i] else -1
                      for i in range(h * w)])
    clusters = []
    for r in np.unique(roots):
        if r < 0:
            continue
        members = np.nonzero(roots == r)[0]
        if len(members) >= min_cluster_size:
            clusters.append(
                np.stack([members // w, members % w], axis=1))
    clusters.sort(key=len, reverse=True)
    return clusters
