// Kiri-TPU native geometry: host-side post-processing for text detection.
//
// First-party replacement for the native capabilities the reference consumed
// through OpenCV + pyclipper (reference: kiri_ocr/detector/db/model.py
// _boxes_from_bitmap/_unclip/_box_score_fast; SURVEY §2.2):
//
//   * connected components with stats (8-connectivity, two-pass union-find)
//   * convex hull (Andrew monotone chain)
//   * min-area rect (rotating calipers over the hull)
//   * polygon area / perimeter
//   * convex polygon offset with round joins (pyclipper JT_ROUND equivalent)
//   * mean-inside-quad box score (half-plane test, no mask allocation)
//
// Exposed as a C ABI consumed via ctypes (kiri_tpu/native/__init__.py).
// Build: g++ -O3 -shared -fPIC -o libkiri_geom.so geometry.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Connected components (8-connectivity), two-pass with union-find.
// labels: int32 [h*w] output (0 = background). Returns number of components.
// stats: per-component int32 [n, 5] = (x, y, w, h, area) written to out_stats
// (caller allocates max_components rows).
// ---------------------------------------------------------------------------
static int uf_find(std::vector<int>& parent, int x) {
    while (parent[x] != x) {
        parent[x] = parent[parent[x]];
        x = parent[x];
    }
    return x;
}

static void uf_union(std::vector<int>& parent, int a, int b) {
    a = uf_find(parent, a);
    b = uf_find(parent, b);
    if (a != b) parent[std::max(a, b)] = std::min(a, b);
}

int connected_components(const uint8_t* bitmap, int h, int w,
                         int32_t* labels, int32_t* out_stats,
                         int max_components) {
    std::vector<int> parent(1, 0);  // parent[0] = background
    std::memset(labels, 0, sizeof(int32_t) * h * w);

    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            if (!bitmap[y * w + x]) continue;
            // neighbors already visited: W, NW, N, NE
            int neigh[4];
            int nn = 0;
            if (x > 0 && labels[y * w + x - 1]) neigh[nn++] = labels[y * w + x - 1];
            if (y > 0) {
                if (x > 0 && labels[(y - 1) * w + x - 1])
                    neigh[nn++] = labels[(y - 1) * w + x - 1];
                if (labels[(y - 1) * w + x]) neigh[nn++] = labels[(y - 1) * w + x];
                if (x + 1 < w && labels[(y - 1) * w + x + 1])
                    neigh[nn++] = labels[(y - 1) * w + x + 1];
            }
            if (nn == 0) {
                int lab = (int)parent.size();
                parent.push_back(lab);
                labels[y * w + x] = lab;
            } else {
                int m = neigh[0];
                for (int i = 1; i < nn; ++i) m = std::min(m, neigh[i]);
                labels[y * w + x] = m;
                for (int i = 0; i < nn; ++i) uf_union(parent, m, neigh[i]);
            }
        }
    }

    // Flatten + renumber.
    std::vector<int> remap(parent.size(), 0);
    int n_comp = 0;
    for (size_t i = 1; i < parent.size(); ++i) {
        if (uf_find(parent, (int)i) == (int)i) remap[i] = ++n_comp;
    }
    if (n_comp > max_components) n_comp = max_components;

    // Stats: x_min, y_min, x_max, y_max, area  (converted to x,y,w,h,area).
    std::vector<int> xmin(n_comp + 1, 1 << 30), ymin(n_comp + 1, 1 << 30);
    std::vector<int> xmax(n_comp + 1, -1), ymax(n_comp + 1, -1);
    std::vector<int> area(n_comp + 1, 0);
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            int lab = labels[y * w + x];
            if (!lab) continue;
            lab = remap[uf_find(parent, lab)];
            if (lab > n_comp) lab = 0;  // overflow -> background
            labels[y * w + x] = lab;
            if (!lab) continue;
            xmin[lab] = std::min(xmin[lab], x);
            ymin[lab] = std::min(ymin[lab], y);
            xmax[lab] = std::max(xmax[lab], x);
            ymax[lab] = std::max(ymax[lab], y);
            area[lab] += 1;
        }
    }
    for (int c = 1; c <= n_comp; ++c) {
        out_stats[(c - 1) * 5 + 0] = xmin[c];
        out_stats[(c - 1) * 5 + 1] = ymin[c];
        out_stats[(c - 1) * 5 + 2] = xmax[c] - xmin[c] + 1;
        out_stats[(c - 1) * 5 + 3] = ymax[c] - ymin[c] + 1;
        out_stats[(c - 1) * 5 + 4] = area[c];
    }
    return n_comp;
}

// ---------------------------------------------------------------------------
// Convex hull — Andrew monotone chain. points: float64 [n, 2].
// out_hull: float64 [n, 2]; returns hull size.
// ---------------------------------------------------------------------------
static double cross(const double* o, const double* a, const double* b) {
    return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0]);
}

int convex_hull(const double* points, int n, double* out_hull) {
    if (n < 3) {
        std::memcpy(out_hull, points, sizeof(double) * 2 * n);
        return n;
    }
    std::vector<std::pair<double, double>> pts(n);
    for (int i = 0; i < n; ++i) pts[i] = {points[2 * i], points[2 * i + 1]};
    std::sort(pts.begin(), pts.end());
    pts.erase(std::unique(pts.begin(), pts.end()), pts.end());
    int m = (int)pts.size();
    if (m < 3) {
        for (int i = 0; i < m; ++i) {
            out_hull[2 * i] = pts[i].first;
            out_hull[2 * i + 1] = pts[i].second;
        }
        return m;
    }
    std::vector<std::pair<double, double>> hull(2 * m);
    int k = 0;
    for (int i = 0; i < m; ++i) {  // lower
        while (k >= 2) {
            double o[2] = {hull[k - 2].first, hull[k - 2].second};
            double a[2] = {hull[k - 1].first, hull[k - 1].second};
            double b[2] = {pts[i].first, pts[i].second};
            if (cross(o, a, b) <= 0) --k; else break;
        }
        hull[k++] = pts[i];
    }
    for (int i = m - 2, t = k + 1; i >= 0; --i) {  // upper
        while (k >= t) {
            double o[2] = {hull[k - 2].first, hull[k - 2].second};
            double a[2] = {hull[k - 1].first, hull[k - 1].second};
            double b[2] = {pts[i].first, pts[i].second};
            if (cross(o, a, b) <= 0) --k; else break;
        }
        hull[k++] = pts[i];
    }
    k -= 1;  // last point == first point
    for (int i = 0; i < k; ++i) {
        out_hull[2 * i] = hull[i].first;
        out_hull[2 * i + 1] = hull[i].second;
    }
    return k;
}

// ---------------------------------------------------------------------------
// Min-area rect via rotating calipers. points: float64 [n, 2].
// out: (cx, cy, w, h, angle_degrees) — cv2.minAreaRect convention:
// angle in (0, 90], w = extent along the edge direction.
// ---------------------------------------------------------------------------
void min_area_rect(const double* points, int n, double* out) {
    std::vector<double> hull(2 * std::max(n, 1));
    int k = convex_hull(points, n, hull.data());
    if (k == 0) { out[0] = out[1] = out[2] = out[3] = out[4] = 0; return; }
    if (k == 1) {
        out[0] = hull[0]; out[1] = hull[1]; out[2] = out[3] = 0; out[4] = 0;
        return;
    }

    double best_area = 1e300;
    double best[5] = {0, 0, 0, 0, 0};
    for (int i = 0; i < k; ++i) {
        int j = (i + 1) % k;
        double ex = hull[2 * j] - hull[2 * i];
        double ey = hull[2 * j + 1] - hull[2 * i + 1];
        double len = std::sqrt(ex * ex + ey * ey);
        if (len < 1e-12) continue;
        ex /= len; ey /= len;
        // Project all hull points on (ex, ey) and its normal.
        double umin = 1e300, umax = -1e300, vmin = 1e300, vmax = -1e300;
        for (int p = 0; p < k; ++p) {
            double u = hull[2 * p] * ex + hull[2 * p + 1] * ey;
            double v = -hull[2 * p] * ey + hull[2 * p + 1] * ex;
            umin = std::min(umin, u); umax = std::max(umax, u);
            vmin = std::min(vmin, v); vmax = std::max(vmax, v);
        }
        double area = (umax - umin) * (vmax - vmin);
        if (area < best_area) {
            best_area = area;
            double cu = (umin + umax) / 2, cv = (vmin + vmax) / 2;
            best[0] = cu * ex - cv * ey;
            best[1] = cu * ey + cv * ex;
            best[2] = umax - umin;
            best[3] = vmax - vmin;
            best[4] = std::atan2(ey, ex) * 180.0 / M_PI;
        }
    }
    // Normalize to cv2 convention: angle in (0, 90].
    double ang = best[4], rw = best[2], rh = best[3];
    while (ang <= 0) ang += 90.0, std::swap(rw, rh);
    while (ang > 90.0) ang -= 90.0, std::swap(rw, rh);
    out[0] = best[0]; out[1] = best[1]; out[2] = rw; out[3] = rh; out[4] = ang;
}

// ---------------------------------------------------------------------------
// Convex polygon offset with round joins (pyclipper JT_ROUND equivalent for
// the convex quads DB produces). poly: float64 [n, 2] CCW or CW.
// out: float64 [max_out, 2]; returns number of output points.
// ---------------------------------------------------------------------------
int offset_convex_polygon(const double* poly, int n, double distance,
                          double* out, int max_out, int arc_points) {
    if (n < 3 || distance <= 0) {
        int m = std::min(n, max_out);
        std::memcpy(out, poly, sizeof(double) * 2 * m);
        return m;
    }
    // Determine orientation (signed area).
    double sa = 0;
    for (int i = 0; i < n; ++i) {
        int j = (i + 1) % n;
        sa += poly[2 * i] * poly[2 * j + 1] - poly[2 * j] * poly[2 * i + 1];
    }
    double orient = sa >= 0 ? 1.0 : -1.0;

    int m = 0;
    for (int i = 0; i < n; ++i) {
        int prev = (i + n - 1) % n;
        int next = (i + 1) % n;
        // Outward normals of the two adjacent edges.
        double e1x = poly[2 * i] - poly[2 * prev];
        double e1y = poly[2 * i + 1] - poly[2 * prev + 1];
        double e2x = poly[2 * next] - poly[2 * i];
        double e2y = poly[2 * next + 1] - poly[2 * i + 1];
        double l1 = std::hypot(e1x, e1y), l2 = std::hypot(e2x, e2y);
        if (l1 < 1e-12 || l2 < 1e-12) continue;
        double n1x = orient * e1y / l1, n1y = -orient * e1x / l1;
        double n2x = orient * e2y / l2, n2y = -orient * e2x / l2;
        double a1 = std::atan2(n1y, n1x);
        double a2 = std::atan2(n2y, n2x);
        // Sweep the arc from n1 to n2 the short (convex) way.
        double da = a2 - a1;
        while (da > M_PI) da -= 2 * M_PI;
        while (da < -M_PI) da += 2 * M_PI;
        int steps = std::max(1, (int)(std::fabs(da) / M_PI * arc_points));
        for (int s = 0; s <= steps && m < max_out; ++s) {
            double a = a1 + da * s / steps;
            out[2 * m] = poly[2 * i] + distance * std::cos(a);
            out[2 * m + 1] = poly[2 * i + 1] + distance * std::sin(a);
            ++m;
        }
    }
    return m;
}

// ---------------------------------------------------------------------------
// Mean of `pred` (float32 [h, w]) inside quad `box` (float64 [4, 2]).
// Half-plane containment over the quad's AABB — no mask allocation.
// ---------------------------------------------------------------------------
double box_score(const float* pred, int h, int w, const double* box) {
    double xmin = 1e300, xmax = -1e300, ymin = 1e300, ymax = -1e300;
    for (int i = 0; i < 4; ++i) {
        xmin = std::min(xmin, box[2 * i]);
        xmax = std::max(xmax, box[2 * i]);
        ymin = std::min(ymin, box[2 * i + 1]);
        ymax = std::max(ymax, box[2 * i + 1]);
    }
    int x0 = std::max(0, std::min(w - 1, (int)std::floor(xmin)));
    int x1 = std::max(0, std::min(w - 1, (int)std::ceil(xmax)));
    int y0 = std::max(0, std::min(h - 1, (int)std::floor(ymin)));
    int y1 = std::max(0, std::min(h - 1, (int)std::ceil(ymax)));
    if (x1 <= x0 || y1 <= y0) return 0.0;

    // Orientation of the quad.
    double sa = 0;
    for (int i = 0; i < 4; ++i) {
        int j = (i + 1) % 4;
        sa += box[2 * i] * box[2 * j + 1] - box[2 * j] * box[2 * i + 1];
    }
    double orient = sa >= 0 ? 1.0 : -1.0;

    double total = 0;
    long count = 0;
    for (int y = y0; y <= y1; ++y) {
        for (int x = x0; x <= x1; ++x) {
            bool inside = true;
            for (int i = 0; i < 4 && inside; ++i) {
                int j = (i + 1) % 4;
                double c = (box[2 * j] - box[2 * i]) * (y - box[2 * i + 1]) -
                           (box[2 * j + 1] - box[2 * i + 1]) * (x - box[2 * i]);
                if (orient * c < 0) inside = false;
            }
            if (inside) { total += pred[y * w + x]; ++count; }
        }
    }
    return count ? total / count : 0.0;
}

// ---------------------------------------------------------------------------
// Polygon area + perimeter (shapely replacement for the unclip distance).
// ---------------------------------------------------------------------------
void polygon_area_perimeter(const double* poly, int n, double* out_area,
                            double* out_perimeter) {
    double a = 0, p = 0;
    for (int i = 0; i < n; ++i) {
        int j = (i + 1) % n;
        a += poly[2 * i] * poly[2 * j + 1] - poly[2 * j] * poly[2 * i + 1];
        p += std::hypot(poly[2 * j] - poly[2 * i],
                        poly[2 * j + 1] - poly[2 * i + 1]);
    }
    *out_area = std::fabs(a) / 2.0;
    *out_perimeter = p;
}

// ---------------------------------------------------------------------------
// Boundary extraction: pixels of component `label` with a 4-background
// neighbor. Used to feed min_area_rect without full contour tracing.
// out_points: float64 [max_pts, 2]; returns count.
// ---------------------------------------------------------------------------
int component_boundary(const int32_t* labels, int h, int w, int label,
                       double* out_points, int max_pts) {
    int m = 0;
    for (int y = 0; y < h && m < max_pts; ++y) {
        for (int x = 0; x < w && m < max_pts; ++x) {
            if (labels[y * w + x] != label) continue;
            bool edge = (x == 0 || y == 0 || x == w - 1 || y == h - 1 ||
                         labels[y * w + x - 1] != label ||
                         labels[y * w + x + 1] != label ||
                         labels[(y - 1) * w + x] != label ||
                         labels[(y + 1) * w + x] != label);
            if (edge) {
                out_points[2 * m] = x;
                out_points[2 * m + 1] = y;
                ++m;
            }
        }
    }
    return m;
}

// Dilate a binary map with a k x k square kernel (CRAFT postproc helper).
void dilate(const uint8_t* in, int h, int w, int k, uint8_t* out) {
    int r = k / 2;
    for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
            uint8_t v = 0;
            for (int dy = -r; dy <= r && !v; ++dy) {
                int yy = y + dy;
                if (yy < 0 || yy >= h) continue;
                for (int dx = -r; dx <= r; ++dx) {
                    int xx = x + dx;
                    if (xx >= 0 && xx < w && in[yy * w + xx]) { v = 1; break; }
                }
            }
            out[y * w + x] = v;
        }
    }
}

}  // extern "C"
